"""``device_idle_pct.hh``: the share of the profiled window in which no
kernel, copy or memset ran on the card, in the Hodgkin-Huxley network's
cell, in percent. Moves ``ei_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.device_idle_pct
