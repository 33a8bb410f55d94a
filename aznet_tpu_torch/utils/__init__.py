"""Weight conversion from the JAX package, float32 precision scope, the host
library bindings, host box math, timer, metric logging and snapshots."""
