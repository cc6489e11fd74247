"""The Hodgkin-Huxley network's cell (``coba_hh.400k``) through the harness
on the CPU, at scale 0.25 (1,000 neurons) over 300-step trials: a sound
run is ``correct``; the control (the plain reference in bfloat16, the
precision below the configuration's float32), one v, m or g_e one ulp
off and one armed flag flipped are not; a traced run's readers read the
program's spans and counter; a program without the entry stops before
any set-up; and the work counts by hand."""

import time

import pytest
import torch

import brainevent_torch as bt
from benchmark_torch import run
from benchmark_torch.harness import spec

from _tiny import SEED, TRIALS

CPU = torch.device('cpu')
CELL = 'coba_hh.400k'
CFG = spec.load_part('configs', 'coba_hh')
REF = spec.load_module('reference', 'coba_hh')
METRICS = ('launches_per_step.hh', 'kernel_roofline.hh', 'step_mfu.hh',
           'device_idle_pct.hh', 'entry_host_pct.hh',
           'neuron_updates_per_us.hh')


def measure(trace=False):
    return run.measure(CELL, SEED, 0.3, trace, CPU, time.perf_counter(),
                       traffic=TRIALS)


def test_a_sound_run_is_correct():
    record = measure()
    assert record['checked'] >= 1 and record['failed'] == 0, record
    assert all(v == 0 for v, _ in record['checks'].values())
    assert len(record['checks']) == 8
    assert record['steps'] % TRIALS['trial_steps'] == 0


def test_a_traced_run_reads_the_spans_and_the_counter():
    record = measure(trace=True)
    assert record['failed'] == 0
    read = {name: spec.load_module('metrics', name).read for name in METRICS}
    pct = read['entry_host_pct.hh'](record)
    assert 0 < pct <= 100
    assert record['entry_host_s'] <= record['traced_seconds']
    assert record['neuron_updates'] == 1000 * TRIALS['trial_steps'] * (
        TRIALS['trace_trials'])
    # the device's metrics read nothing from a CPU run, nor the update rate
    # without K21's HH instance in the trace
    assert record['hh_kernel_s'] is None
    for name in METRICS:
        if name != 'entry_host_pct.hh':
            assert read[name](record) is None, name
    ops, nbytes = record['traced_work']
    assert ops > 404 * 1000 * 300 and nbytes > 58 * 1000


def test_neuron_updates_per_us_reads_the_counter_over_k21s_time():
    read = spec.load_module('metrics', 'neuron_updates_per_us.hh').read
    assert read(dict(neuron_updates=None, hh_kernel_s=0.5)) is None
    assert read(dict(neuron_updates=10, hh_kernel_s=None)) is None
    assert read(dict(platform='gpu')) is None
    assert read(dict(neuron_updates=4_000_000, hh_kernel_s=0.002)) == 2000


def test_a_program_without_the_entry_stops_before_set_up(monkeypatch):
    monkeypatch.delattr(bt, 'HHNet')
    drawn = []
    monkeypatch.setattr(REF, 'make_inputs',
                        lambda *a, **k: drawn.append(1))
    with pytest.raises(AttributeError, match='HHNet'):
        measure()
    assert drawn == []


def test_a_program_of_other_constants_is_refused():
    driver = spec.load_module('drivers', 'hh_trials')
    inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
    cfg = dict(CFG, neuron=dict(CFG['neuron'], v_t=-64.0))
    with pytest.raises(ValueError, match='v_t'):
        driver.System(cfg, TRIALS, inputs, CPU)


def _altered(monkeypatch, change):
    original = bt.HHNet.run

    def altered(self, n_steps, state=None):
        return change(original(self, n_steps, state=state))
    monkeypatch.setattr(bt.HHNet, 'run', altered)


def control(monkeypatch):
    """The reference in bfloat16 in the program's place."""
    def run_control(self, n_steps, state=None):
        inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
        out = REF.simulate(CFG, TRIALS, inputs, state._asdict(), n_steps,
                           dtype=torch.bfloat16)
        return bt.HHNetState(**out)
    monkeypatch.setattr(bt.HHNet, 'run', run_control)


def _next_float(x: torch.Tensor, i: int) -> torch.Tensor:
    x = x.clone()
    x[i] = torch.nextafter(x[i], torch.tensor(float('inf')))
    return x


def _ulp(field):
    def fault(monkeypatch):
        _altered(monkeypatch, lambda out: out._replace(
            **{field: _next_float(getattr(out, field), 0)}))
    fault.__name__ = f'{field}_ulp'
    return fault


def armed_flipped(monkeypatch):
    """The first neuron's armed flag, the other way."""
    def change(out):
        armed = out.armed.clone()
        armed[0] = ~armed[0]
        return out._replace(armed=armed)
    _altered(monkeypatch, change)


@pytest.mark.parametrize('fault', [control, _ulp('v'), _ulp('m'),
                                   _ulp('g_e'), armed_flipped],
                         ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    record = measure()
    assert record['failed'] == record['checked'] >= 1
    assert any(v > limit for v, limit in record['checks'].values())


def test_the_control_differs_in_every_float():
    inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
    state = inputs['states'][0]
    want = REF.simulate(CFG, TRIALS, inputs, state, 300)
    got = REF.simulate(CFG, TRIALS, inputs, state, 300, dtype=torch.bfloat16)
    values = REF.compare(CFG, inputs, got, want)
    for k in ('v', 'm', 'h', 'n', 'g_e', 'g_i'):
        assert values[f'{k}_mismatch'] > 0, values


def test_the_work_by_hand():
    """Three neurons of two targets each; over two trials 3 + 1 + 0 and 2 +
    0 + 0 spikes: 6 spikes from 3 rows that spiked."""
    work = spec.load_module('work', 'coba_hh')
    inputs = dict(conn=torch.zeros(3, 2, dtype=torch.int32))
    total = (work.reduce(CFG, inputs, dict(
        spike_count=torch.tensor([3, 1, 0], dtype=torch.int32)))
        + work.reduce(CFG, inputs, dict(
            spike_count=torch.tensor([2, 0, 0], dtype=torch.int32))))
    assert total.tolist() == [6, 3]
    ops, nbytes = work.count(CFG, inputs, total, 2, 10)
    assert ops == 404 * 3 * 10 * 2 + 2 * 6
    assert nbytes == 58 * 3 * 2 + 4 * 2 * 3
