"""``update_us_per_step.mc``: the mean warp's time a step in K23's
update phase (the update and the Poisson draw, with the state's load and
store) over the profiled trials of ``pd_microcircuit.77k``, in µs, from
the program's phase clocks
(``brainevent_torch.MicrocircuitNet.phase_ns.update`` over
``.phase_warp_steps``, counted over the profiled trials alone). A run
whose program has no such counters reads nothing. Moves
``ei_40k_us_per_step``."""

from benchmark_torch.harness import phases


def read(record: dict):
    return phases.us_per_step(record, 'MicrocircuitNet', 'update')
