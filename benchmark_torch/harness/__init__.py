"""The shared parts of the benchmark: files found by name, the card, the
clock, the profiler's window, the roofline and the result line."""
