"""``device_idle_pct.istdp``: the share of the profiled window in which no
kernel, copy or memset ran on the card, in the cell of Vogels et al.
2011's network, in percent. Moves ``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.device_idle_pct
