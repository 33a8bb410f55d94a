"""The benchmark's harness: the data it is driven by (``spec``), what it
makes from the seed (``inputs``), the system under test (``system``), the
run (``runner``, ``driver``), the trace (``trace``), the check (``check``)
and the yardstick's arithmetic (``roofline``)."""
