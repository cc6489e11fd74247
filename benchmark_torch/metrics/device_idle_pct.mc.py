"""``device_idle_pct.mc``: the share of the profiled window in which no
kernel, copy or memset ran on the card, in the microcircuit cell, in
percent. Moves ``ei_40k_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.device_idle_pct
