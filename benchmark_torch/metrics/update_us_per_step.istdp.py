"""``update_us_per_step.istdp``: the mean warp's time a step in the update
phase of K24's iSTDP instance (phase A: the update of the neurons and
their traces and the rows' lists, with the state's load and store) over
the profiled trials of ``vogels_istdp.200k``, in µs, from the program's
phase clocks (``brainevent_torch.IstdpNet.phase_ns.update`` over
``.phase_warp_steps``, counted over the profiled trials alone). A run
whose program has no such counters reads nothing. Moves
``ei_us_per_step``."""

from benchmark_torch.harness import phases


def read(record: dict):
    return phases.us_per_step(record, 'IstdpNet', 'update')
