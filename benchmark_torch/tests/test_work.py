"""The work counts against hand-computed values at tiny sizes."""

import pytest
import torch

from benchmark_torch.harness import readers, spec
from benchmark_torch.harness.roofline import least_seconds
from benchmark_torch.harness.trace import Trace


@pytest.mark.parametrize('config, per_neuron_step',
                         [('coba_ei', 20), ('cuba_ei', 16)])
def test_ei_work_by_hand(config, per_neuron_step):
    work = spec.load_module('work', config)
    inputs = dict(conn=torch.zeros(10, 3, dtype=torch.int32))
    counts = [torch.tensor([0, 2, 0, 1, 0, 0, 0, 0, 0, 5]),
              torch.zeros(10, dtype=torch.int32)]
    total = sum(work.reduce({}, inputs, dict(spike_count=c)) for c in counts)
    ops, nbytes = work.count({}, inputs, total, 2, 7)
    # per_neuron_step a neuron a step, 1 a hit (8 spikes x 3 targets); the
    # state read and written once (40 a neuron), the rows of the 3 neurons
    # that spiked
    assert ops == 2 * per_neuron_step * 10 * 7 + 8 * 3
    assert nbytes == 2 * 40 * 10 + 4 * 3 * 3


def test_jitc_work_by_hand():
    work = spec.load_module('work', 'jitc_coba_ei')
    cfg = spec.load_part('configs', 'jitc_coba_ei')
    degree = dict(e=torch.tensor([2, 0, 3]), i=torch.tensor([4]))
    inputs = dict(num=4, n_exc=3, matrix={k: dict(out_degree=v)
                                           for k, v in degree.items()})
    out = dict(spike_count=torch.tensor([1, 5, 2, 1], dtype=torch.int32))
    ops, nbytes = work.count(cfg, inputs, work.reduce(cfg, inputs, out), 1,
                             10)
    edges = 1 * 2 + 5 * 0 + 2 * 3 + 1 * 4
    assert ops == 20 * 4 * 10 + 2 * 128 * 9 + 50 * edges
    assert nbytes == 40 * 4


def test_least_time_takes_the_larger_bound():
    assert least_seconds(67e12, 1.0) == (1.0, 'operations')
    assert least_seconds(1.0, 6.7e12) == (2.0, 'bytes')


def test_shares_from_a_trace():
    trace = Trace(window_s=2.0, busy_s=0.5, device_op_s=0.6,
                  n_device_ops=30, n_by_kind={'kernel': 30}, device_ops=[],
                  idle_gaps=[])
    record = dict(platform='gpu', trace=trace, traced_steps=10,
                  traced_work=(67e12 * 0.3, 0), window_work=(67e12 * 0.1, 0),
                  seconds=4.0)
    assert readers.launches_per_step(record) == 3.0
    assert abs(readers.kernel_roofline_pct(record) - 50.0) < 1e-9
    assert abs(readers.step_mfu_pct(record) - 2.5) < 1e-9
    assert readers.device_idle_pct(record) == 75.0
