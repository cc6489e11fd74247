"""``entry_host_pct.istdp``: the host time of the entry's root spans
(``brainevent_torch.IstdpNet.run``, the program's own tracing, turned on
for the profiled trials only) over those trials' wall time, in percent,
read as ``entry_host_pct.mc`` reads the microcircuit's. A run whose
program records no such span reads nothing. Moves
``ei_us_per_step``."""

from benchmark_torch.harness import spec

read = spec.load_module('metrics', 'entry_host_pct.mc').read
