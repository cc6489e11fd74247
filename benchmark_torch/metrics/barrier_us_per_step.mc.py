"""``barrier_us_per_step.mc``: the mean warp's time a step in K23's
barrier phase (from arriving at the step's grid barrier to leaving it,
the wait for the slowest block among it) over the profiled trials of
``pd_microcircuit.77k``, in µs, from the program's phase clocks
(``brainevent_torch.MicrocircuitNet.phase_ns.barrier`` over
``.phase_warp_steps``, counted over the profiled trials alone). A run
whose program has no such counters reads nothing. Moves
``ei_40k_us_per_step``."""

from benchmark_torch.harness import phases


def read(record: dict):
    return phases.us_per_step(record, 'MicrocircuitNet', 'barrier')
