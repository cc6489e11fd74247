"""``plastic_updates_per_us.stdp``: K24's depressions and facilitations in
the profiled trials (the program's counters
``brainevent_torch.HpcStdpNet.depressions`` and ``.facilitations``, on for
those trials only) over K24's device time there (its kernel by name in
the device trace), per microsecond. A run whose program has no such
counters, or whose trace holds no K24, reads nothing. Moves
``ei_40k_us_per_step``."""


def read(record: dict):
    updates, seconds = (record.get('plastic_updates'),
                        record.get('stdp_kernel_s'))
    if updates is None or not seconds:
        return None
    return updates / (seconds * 1e6)
