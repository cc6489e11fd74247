"""``step_mfu.cuba``: the least time the window's trials need on an H100 over
the window's wall time with the profiler off, in percent. Moves
``cuba_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.step_mfu_pct
