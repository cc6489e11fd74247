"""``kernel_roofline.istdp``: the least time the profiled trials' work needs
on an H100 (``work/vogels_istdp.py``, the published peaks) over the summed
device time of the operations that ran in the window (K24's iSTDP
instance nearly all of it, then the trial's copies of the state), in
percent. Moves ``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.kernel_roofline_pct
