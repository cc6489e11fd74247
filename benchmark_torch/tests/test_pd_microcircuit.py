"""The microcircuit cell (``pd_microcircuit.77k``) through the harness on
the CPU, at scale 0.02 (1,544 neurons, 119,729 synapses): a sound run is
``correct``; the control (the plain reference in bfloat16, the precision
below the configuration's float32), one ring entry off by one and one
spike missing are not; and the work counts by hand."""

import time

import pytest
import torch

import brainevent_torch as bt
from benchmark_torch import run
from benchmark_torch.harness import spec

from _tiny import SEED

CPU = torch.device('cpu')
CELL = 'pd_microcircuit.77k'
TRIALS = dict(kind='trials', scale=0.02, trial_steps=300, initial_states=3,
              warm_steps=20, trace_trials=1, check_trials=2)
CFG = spec.load_part('configs', 'pd_microcircuit')
REF = spec.load_module('reference', 'pd_microcircuit')


def measure(trace=False):
    return run.measure(CELL, SEED, 0.3, trace, CPU, time.perf_counter(),
                       traffic=TRIALS)


def test_a_sound_run_is_correct():
    record = measure()
    assert record['checked'] >= 1 and record['failed'] == 0, record
    assert all(v == 0 for v, _ in record['checks'].values())
    assert record['steps'] % TRIALS['trial_steps'] == 0


def test_a_traced_run_reads_the_entry_spans():
    record = measure(trace=True)
    assert record['failed'] == 0
    pct = spec.load_module('metrics', 'entry_host_pct.mc').read(record)
    assert 0 < pct <= 100
    assert record['entry_host_s'] <= record['traced_seconds']
    # the device's metrics read nothing from a CPU run
    for name in ('launches_per_step.mc', 'kernel_roofline.mc', 'step_mfu.mc',
                 'device_idle_pct.mc'):
        assert spec.load_module('metrics', name).read(record) is None
    ops, nbytes = record['traced_work']
    assert ops > 28 * 1544 * 300 and nbytes > 0


def test_entry_host_pct_reads_nothing_without_spans():
    read = spec.load_module('metrics', 'entry_host_pct.mc').read
    assert read(dict(entry_host_s=None, traced_seconds=1.0)) is None
    assert read(dict(platform='gpu')) is None
    assert read(dict(entry_host_s=0.002, traced_seconds=4.0)) == 0.05


def _altered(monkeypatch, change):
    original = bt.MicrocircuitNet.run

    def altered(self, n_steps, state=None):
        return change(original(self, n_steps, state=state))
    monkeypatch.setattr(bt.MicrocircuitNet, 'run', altered)


def control(monkeypatch):
    """The reference in bfloat16 in the program's place."""
    def run_control(self, n_steps, state=None):
        inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
        out = REF.simulate(CFG, TRIALS, inputs, state._asdict(), n_steps,
                           dtype=torch.bfloat16)
        return state._replace(**out)
    monkeypatch.setattr(bt.MicrocircuitNet, 'run', run_control)


def ring_entry(monkeypatch):
    """One pending input off by one weight unit."""
    def change(out):
        ring = out.ring.clone()
        ring[0, 0] += 1
        return out._replace(ring=ring)
    _altered(monkeypatch, change)


def missing_spike(monkeypatch):
    """The first neuron that spiked, short one spike."""
    def change(out):
        count = out.spike_count.clone()
        count[int(torch.nonzero(count)[0])] -= 1
        return out._replace(spike_count=count)
    _altered(monkeypatch, change)


@pytest.mark.parametrize('fault', [control, ring_entry, missing_spike],
                         ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    record = measure()
    assert record['failed'] == record['checked'] >= 1
    assert any(v > limit for v, limit in record['checks'].values())


def test_the_control_differs_in_every_array():
    inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
    state = inputs['states'][0]
    want = REF.simulate(CFG, TRIALS, inputs, state, 300)
    got = REF.simulate(CFG, TRIALS, inputs, state, 300, dtype=torch.bfloat16)
    values = REF.compare(CFG, inputs, got, want)
    assert all(v > 0 for v in values.values()), values


def test_the_work_by_hand():
    work = spec.load_module('work', 'pd_microcircuit')
    degree = torch.tensor([3, 0, 5, 2])
    inputs = dict(num=4, depth=8, net=dict(degree=degree))
    counts = [torch.tensor([1, 4, 0, 2], dtype=torch.int32),
              torch.tensor([0, 0, 3, 0], dtype=torch.int32)]
    total = sum(work.reduce(CFG, inputs, dict(spike_count=c))
                for c in counts)
    ops, nbytes = work.count(CFG, inputs, total, 2, 10)
    # synapse events: 1*3 + 4*0 + 2*2 in the first trial, 3*5 in the second,
    # each a row entry read; spikes 1 + 4 + 2 and 3, each its row's bounds
    assert ops == 28 * 4 * 10 * 2 + 5 * (3 + 4 + 15)
    assert nbytes == (32 + 8 * 8) * 4 * 2 + 7 * (3 + 4 + 15) + 8 * (7 + 3)
