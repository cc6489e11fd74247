"""``flush_us_per_step.stdp``: the mean warp's time a step in K24's
flush phase (the flush of the facilitations still owed at the launch's
end, over the launch's steps) over the profiled trials of
``hpc_stdp.112k``, in µs, from the program's phase clocks
(``brainevent_torch.HpcStdpNet.phase_ns.flush`` over
``.phase_warp_steps``, counted over the profiled trials alone). A run
whose program has no such counters reads nothing. Moves
``ei_40k_us_per_step``."""

from benchmark_torch.harness import phases


def read(record: dict):
    return phases.us_per_step(record, 'HpcStdpNet', 'flush')
