"""``scatter_us_per_step.istdp``: the mean warp's time a step in the scatter
phase of K24's iSTDP instance (phase B's scatter of the step's static
rows, a warp a row, with global atomics into the ring) over the profiled
trials of ``vogels_istdp.200k``, in µs, from the program's phase clocks
(``brainevent_torch.IstdpNet.phase_ns.scatter`` over
``.phase_warp_steps``, counted over the profiled trials alone). A run
whose program has no such counters reads nothing. Moves
``ei_us_per_step``."""

from benchmark_torch.harness import phases


def read(record: dict):
    return phases.us_per_step(record, 'IstdpNet', 'scatter')
