"""``entry_host_pct.mc``: the host time of the entry's root spans
(``brainevent_torch.MicrocircuitNet.run``, the program's own tracing,
turned on for the profiled trials only) over those trials' wall time, in
percent: the share of a trial the host spends inside the entry. A run
whose program records no such span reads nothing. Moves
``ei_40k_us_per_step``."""


def read(record: dict):
    host, seconds = record.get('entry_host_s'), record.get('traced_seconds')
    if host is None or not seconds:
        return None
    return 100.0 * host / seconds
