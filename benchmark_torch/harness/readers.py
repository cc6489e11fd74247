"""The arithmetic of the metrics, shared by the readers in ``metrics/``.

Each reader takes a run's record and returns a number, or ``None`` when
the run holds nothing to read (no trace, no device time): the run then
leaves that metric out of its line. No reader clamps a share.
"""

from benchmark_torch.harness.roofline import least_seconds


def us_per_step(record: dict) -> float:
    """All simulated steps of the window's trials over the window's whole
    wall time, in microseconds a step."""
    return record['seconds'] / record['steps'] * 1e6


def setup_s(record: dict) -> float:
    """Seconds from the start of the process to the window's first call."""
    return record['setup_s']


def _on_card(record: dict):
    trace = record.get('trace')
    if record.get('platform') != 'gpu' or trace is None:
        return None
    return trace


def launches_per_step(record: dict):
    """Device operations (kernels, copies, memsets) in the profiled
    window over the steps its trials simulated."""
    trace = _on_card(record)
    if trace is None or not trace.n_device_ops:
        return None
    return trace.n_device_ops / record['traced_steps']


def kernel_roofline_pct(record: dict):
    """The least time the profiled trials' work needs on the card, over
    the summed device time of the operations that ran in the window."""
    trace = _on_card(record)
    if trace is None or trace.device_op_s <= 0:
        return None
    least, _ = least_seconds(*record['traced_work'])
    return 100.0 * least / trace.device_op_s


def step_mfu_pct(record: dict):
    """The least time the window's trials need on the card, over the
    window's wall time (the profiler off)."""
    if _on_card(record) is None:
        return None
    least, _ = least_seconds(*record['window_work'])
    return 100.0 * least / record['seconds']


def device_idle_pct(record: dict):
    """The share of the profiled window in which no kernel, copy or
    memset ran on the card."""
    trace = _on_card(record)
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
