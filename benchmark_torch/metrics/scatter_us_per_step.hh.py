"""``scatter_us_per_step.hh``: the mean warp's time a step in K21's HH
instance's scatter phase (the ballot and the scatter of each warp's
spikes into the hit counts) over the profiled trials of
``coba_hh.400k``, in µs, from the program's phase clocks
(``brainevent_torch.HHNet.phase_ns.scatter`` over ``.phase_warp_steps``,
counted over the profiled trials alone). A run whose program has no such
counters reads nothing. Moves ``ei_us_per_step``."""

from benchmark_torch.harness import phases


def read(record: dict):
    return phases.us_per_step(record, 'HHNet', 'scatter')
