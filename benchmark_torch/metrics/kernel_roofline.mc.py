"""``kernel_roofline.mc``: the least time the profiled trials' work needs on
an H100 (``work/pd_microcircuit.py``, the published peaks) over the summed
device time of the operations that ran in the window (K23 nearly all of
it), in percent. Moves ``ei_40k_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.kernel_roofline_pct
