"""``step_mfu.ei_40k``: the least time the window's trials need on an H100 over
the window's wall time with the profiler off, in percent. Moves
``ei_40k_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.step_mfu_pct
