"""The phases of a whole-trial kernel's step, read from the program's own
phase clocks.

With tracing on, the entries of K24 (``HpcStdpNet``), K21's HH instance
(``HHNet``) and K23 (``MicrocircuitNet``) launch their kernels' clocked
instances, in which each warp times its launch in the phases of the step,
and add the grid's warps' ns in each phase to the program's counter
``brainevent_torch.<entry>.phase_ns.<phase>`` and the grid's warps times
the launch's steps to ``brainevent_torch.<entry>.phase_warp_steps``. A
traced run turns tracing on for its profiled trials alone
(``drivers/*_trials.py``), and the program's ``tracing.session_counts()``
keeps those trials' counts until tracing is next turned on, whatever the
run drained.
"""


def us_per_step(record: dict, entry: str, phase: str):
    """The mean warp's time a step in *phase* of *entry*'s kernel over the
    profiled trials, in µs: the phase's ns over the warps' steps. None off
    the card, without a profiled window, or where the program records no
    such counters (a program without phase clocks)."""
    if record.get('platform') != 'gpu' or record.get('trace') is None:
        return None
    from brainevent_torch.ops import tracing
    session = getattr(tracing, 'session_counts', None)
    if session is None:
        return None
    counts = session()
    prefix = f'brainevent_torch.{entry}.phase_'
    ns = counts.get(f'{prefix}ns.{phase}')
    warp_steps = counts.get(f'{prefix}warp_steps')
    if ns is None or not warp_steps:
        return None
    return ns / warp_steps * 1e-3
