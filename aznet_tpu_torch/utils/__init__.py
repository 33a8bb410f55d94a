"""Weight conversion from the JAX package."""
