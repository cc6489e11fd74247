"""The HPC benchmark network's cell (``hpc_stdp.112k``) through the harness
on the CPU, at scale 0.01 (112 neurons at the configuration's in-degrees,
1,262,250 synapses, 810,000 of them plastic): a sound run is
``correct``; the control (the plain reference in bfloat16, the precision
below the configuration's float32), one weight one ulp off, one K+ one ulp
off and one spike missing are not; a program without the entry stops
before any set-up; and the work counts by hand."""

import time

import pytest
import torch

import brainevent_torch as bt
from benchmark_torch import run
from benchmark_torch.harness import spec

from _tiny import SEED

CPU = torch.device('cpu')
CELL = 'hpc_stdp.112k'
TRIALS = dict(kind='trials', scale=0.01, trial_steps=300, initial_states=3,
              warm_steps=20, trace_trials=1, check_trials=2)
CFG = spec.load_part('configs', 'hpc_stdp')
REF = spec.load_module('reference', 'hpc_stdp')
METRICS = ('launches_per_step.stdp', 'kernel_roofline.stdp', 'step_mfu.stdp',
           'device_idle_pct.stdp', 'entry_host_pct.stdp',
           'plastic_updates_per_us.stdp')


def measure(trace=False):
    return run.measure(CELL, SEED, 0.3, trace, CPU, time.perf_counter(),
                       traffic=TRIALS)


def test_a_sound_run_is_correct():
    record = measure()
    assert record['checked'] >= 1 and record['failed'] == 0, record
    assert all(v == 0 for v, _ in record['checks'].values())
    assert len(record['checks']) == 10
    assert record['steps'] % TRIALS['trial_steps'] == 0


def test_a_traced_run_reads_the_spans_and_the_counters():
    record = measure(trace=True)
    assert record['failed'] == 0
    read = {name: spec.load_module('metrics', name).read for name in METRICS}
    pct = read['entry_host_pct.stdp'](record)
    assert 0 < pct <= 100
    assert record['entry_host_s'] <= record['traced_seconds']
    assert record['plastic_updates'] > 0
    # the device's metrics read nothing from a CPU run, nor K24's rate
    # without K24 in the trace
    assert record['stdp_kernel_s'] is None
    for name in METRICS:
        if name != 'entry_host_pct.stdp':
            assert read[name](record) is None, name
    ops, nbytes = record['traced_work']
    assert ops > 35 * 112 * 300 and nbytes > 0


def test_plastic_updates_per_us_reads_the_counters_over_k24s_time():
    read = spec.load_module('metrics', 'plastic_updates_per_us.stdp').read
    assert read(dict(plastic_updates=None, stdp_kernel_s=0.5)) is None
    assert read(dict(plastic_updates=10, stdp_kernel_s=None)) is None
    assert read(dict(platform='gpu')) is None
    assert read(dict(plastic_updates=3_000_000, stdp_kernel_s=0.001)) == 3000


def test_a_program_without_the_entry_stops_before_set_up(monkeypatch):
    monkeypatch.delattr(bt, 'HpcStdpNet')
    drawn = []
    monkeypatch.setattr(REF, 'make_inputs',
                        lambda *a, **k: drawn.append(1))
    with pytest.raises(AttributeError, match='HpcStdpNet'):
        measure()
    assert drawn == []


def _altered(monkeypatch, change):
    original = bt.HpcStdpNet.run

    def altered(self, n_steps, state=None):
        return change(original(self, n_steps, state=state))
    monkeypatch.setattr(bt.HpcStdpNet, 'run', altered)


def control(monkeypatch):
    """The reference in bfloat16 in the program's place."""
    def run_control(self, n_steps, state=None):
        inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
        out = REF.simulate(CFG, TRIALS, inputs, state._asdict(), n_steps,
                           dtype=torch.bfloat16)
        return state._replace(step=state.step + n_steps, **out)
    monkeypatch.setattr(bt.HpcStdpNet, 'run', run_control)


def _next_float(x: torch.Tensor, i: int) -> torch.Tensor:
    x = x.clone()
    x[i] = torch.nextafter(x[i], torch.tensor(float('inf')))
    return x


def weight_ulp(monkeypatch):
    """The first weight, one ulp up."""
    def change(out):
        return out._replace(weights=_next_float(out.weights, 0))
    _altered(monkeypatch, change)


def kplus_ulp(monkeypatch):
    """The first excitatory neuron's K+, one ulp up."""
    def change(out):
        return out._replace(kplus=_next_float(out.kplus, 0))
    _altered(monkeypatch, change)


def missing_spike(monkeypatch):
    """The first neuron that spiked, short one spike."""
    def change(out):
        count = out.spike_count.clone()
        count[int(torch.nonzero(count)[0])] -= 1
        return out._replace(spike_count=count)
    _altered(monkeypatch, change)


@pytest.mark.parametrize('fault', [control, weight_ulp, kplus_ulp,
                                   missing_spike], ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    record = measure()
    assert record['failed'] == record['checked'] >= 1
    assert any(v > limit for v, limit in record['checks'].values())


def test_the_control_differs_in_the_floats_and_the_weights():
    inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
    state = inputs['states'][0]
    want = REF.simulate(CFG, TRIALS, inputs, state, 300)
    got = REF.simulate(CFG, TRIALS, inputs, state, 300, dtype=torch.bfloat16)
    values = REF.compare(CFG, inputs, got, want)
    for k in ('v', 'i_syn', 'di', 'weights', 'kplus', 'khist'):
        assert values[f'{k}_mismatch'] > 0, values


def test_the_work_by_hand():
    """Three neurons, two excitatory: rows 0 -> (1, 1 plastic; 2 static),
    1 -> (0 plastic; 2, 2 static), 2 -> (0, 1 static); a ring of 4, d 3."""
    work = spec.load_module('work', 'hpc_stdp')
    net = dict(plastic_ptr=torch.tensor([0, 2, 3], dtype=torch.int32),
               static_ptr=torch.tensor([3, 4, 6, 8], dtype=torch.int32),
               targets=torch.tensor([1, 1, 0, 2, 2, 2, 0, 1],
                                    dtype=torch.int32),
               weights=torch.ones(3))
    inputs = dict(num=3, ne=2, depth=4, net=net)
    spiked = torch.zeros(4, 2, dtype=torch.uint8)
    spiked[1, 0] = 1     # step 5: one of neuron 0's spikes, recent
    spiked[2, 1] = 1     # step 6: neuron 1's, recent
    spiked[0, 0] = 1     # step 4 = step - D: facilitated
    out = dict(spike_count=torch.tensor([3, 1, 2], dtype=torch.int32),
               spiked=spiked, step=8)
    total = work.reduce(CFG, inputs, out) + work.reduce(CFG, inputs, out)
    # a trial: deliveries 3*3 + 1*3 + 2*2, depressions 3*2 + 1*1,
    # facilitations (3 - 1)*1 + (1 - 1)*2 (neuron 0 has one plastic input,
    # neuron 1 two), spikes 6, E spikes 4
    assert total.tolist() == [32, 14, 4, 12, 8]
    ops, nbytes = work.count(CFG, inputs, total, 2, 10)
    assert ops == ((35 * 3 + 2 * 2) * 10 * 2 + 2 * 8 + 3 * 32 + 6 * 14
                   + 7 * 4)
    assert nbytes == ((40 * 3 + (8 + 40) * 2 + 32 * 3 + 8 * 3) * 2
                      + 4 * 32 + 8 * 14 + 16 * 4 + 16 * 12 + 8 * 8)


def test_each_trial_runs_under_its_own_key():
    """Trials 0 and 3 start from the same initial state (three states)
    under different Poisson keys, so their inputs differ; trial 0 keeps
    the state's key, and the reference replays trial 3 under its key."""
    driver = spec.load_module('drivers', 'stdp_trials')
    inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
    system = driver.System(CFG, TRIALS, inputs, CPU)
    a, b = system.trial(0, 40), system.trial(3, 40)
    assert not torch.equal(a['di'], b['di'])
    assert driver.trial_key(inputs['states'][0]['key'], 0) == (
        inputs['states'][0]['key'])
    want = REF.simulate(CFG, TRIALS, inputs, dict(
        inputs['states'][0], key=driver.trial_key(
            inputs['states'][0]['key'], 3)), 40)
    assert REF.compare(CFG, inputs, b, want) == {
        f'{k}_mismatch': 0 for k in REF.FIELDS}
