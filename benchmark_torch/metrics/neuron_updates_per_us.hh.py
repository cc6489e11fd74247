"""``neuron_updates_per_us.hh``: the HH neurons K21 stepped in the profiled
trials (the program's counter ``brainevent_torch.HHNet.neuron_updates``,
on for those trials only: neurons times steps of each run) over the
device time of K21's HH instance there (its kernel by name in the device
trace), per microsecond. A run whose program has no such counter, or
whose trace holds no such kernel, reads nothing. Moves
``ei_us_per_step``."""


def read(record: dict):
    updates, seconds = record.get('neuron_updates'), record.get('hh_kernel_s')
    if updates is None or not seconds:
        return None
    return updates / (seconds * 1e6)
