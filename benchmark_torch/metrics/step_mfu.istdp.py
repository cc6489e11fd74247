"""``step_mfu.istdp``: the least time the window's trials of Vogels et al.
2011's network need on an H100 over the window's wall time with the
profiler off, in percent. Moves ``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.step_mfu_pct
