"""``kernel_roofline.hh``: the least time the profiled trials' work needs
on an H100 (``work/coba_hh.py``: the HH update's operations, each exp,
expm1 and division at the time of one MUFU instruction, and the hits;
the published peaks) over the summed device time of the operations that
ran in the window (K21's HH instance nearly all of it), in percent. Moves
``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.kernel_roofline_pct
