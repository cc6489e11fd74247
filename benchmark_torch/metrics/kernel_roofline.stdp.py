"""``kernel_roofline.stdp``: the least time the profiled trials' work needs
on an H100 (``work/hpc_stdp.py``, the published peaks) over the summed
device time of the operations that ran in the window (K24 nearly all of
it, then the trial's copy of the weights), in percent. Moves
``ei_40k_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.kernel_roofline_pct
