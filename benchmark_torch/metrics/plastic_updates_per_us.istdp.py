"""``plastic_updates_per_us.istdp``: the pre and post updates of K24's
iSTDP instance in the profiled trials (the program's counters
``brainevent_torch.IstdpNet.pre_updates`` and ``.post_updates``, on for
those trials only) over the instance's device time there (its kernel by
name in the device trace), per microsecond. A run whose program has no
such counters, or whose trace holds no such kernel, reads nothing. Moves
``ei_us_per_step``."""


def read(record: dict):
    updates, seconds = (record.get('plastic_updates'),
                        record.get('istdp_kernel_s'))
    if updates is None or not seconds:
        return None
    return updates / (seconds * 1e6)
