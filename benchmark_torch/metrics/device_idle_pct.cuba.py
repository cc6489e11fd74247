"""``device_idle_pct.cuba``: the share of the profiled window in which no
kernel, copy or memset ran on the card, in percent. Moves
``cuba_us_per_step``."""

from benchmark_torch.harness import readers

read = readers.device_idle_pct
