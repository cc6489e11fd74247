"""The cell of Vogels et al. 2011's network (``vogels_istdp.200k``) through
the harness on the CPU, at scale 0.1 (1,000 neurons at the configuration's
in-degrees, ~0.2 M synapses, ~32 k of them plastic): a sound run is
``correct``; the control (the plain reference in bfloat16, the precision
below the configuration's float32), one v and one weight one ulp off and
one spike missing are not; a traced run's readers read the spans, the
counters and (on a card alone) the phases; a program without the entry
stops before any set-up; and the work counts by hand."""

import time

import pytest
import torch

import brainevent_torch as bt
from benchmark_torch import run
from benchmark_torch.harness import spec
from brainevent_torch.ops import tracing

from _tiny import SEED

CPU = torch.device('cpu')
CELL = 'vogels_istdp.200k'
TRIALS = dict(kind='trials', scale=0.1, trial_steps=300, initial_states=3,
              warm_steps=20, trace_trials=1, check_trials=2)
CFG = spec.load_part('configs', 'vogels_istdp')
REF = spec.load_module('reference', 'vogels_istdp')
PHASES = ('update', 'scatter', 'walk', 'post', 'barrier')
METRICS = ('launches_per_step.istdp', 'kernel_roofline.istdp',
           'step_mfu.istdp', 'device_idle_pct.istdp', 'entry_host_pct.istdp',
           'plastic_updates_per_us.istdp',
           *(f'{ph}_us_per_step.istdp' for ph in PHASES))


def measure(trace=False):
    return run.measure(CELL, SEED, 0.3, trace, CPU, time.perf_counter(),
                       traffic=TRIALS)


def test_a_sound_run_is_correct():
    record = measure()
    assert record['checked'] >= 1 and record['failed'] == 0, record
    assert all(v == 0 for v, _ in record['checks'].values())
    assert len(record['checks']) == 9
    assert record['steps'] % TRIALS['trial_steps'] == 0


def test_the_benchmark_lists_the_cell_and_its_readers():
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, CELL)
    assert (entry['config'], entry['traffic'], entry['chips']) == (
        'vogels_istdp', 'trials_200k_10k', 1)
    per_layer = {m['name'] for m in spec.metrics_of(bench, CELL,
                                                    'per_layer')}
    assert per_layer == set(METRICS)
    e2e = [m['name'] for m in spec.metrics_of(bench, CELL, 'end_to_end')]
    assert len(e2e) == 2 and 'setup_s' in e2e
    traffic = spec.load_part('traffic', 'trials_200k_10k')
    assert bt.IstdpParams().sizes(traffic['scale']) == (160_000, 40_000)
    assert traffic['trial_steps'] == 10_000


def test_a_traced_run_reads_the_spans_and_the_counters():
    record = measure(trace=True)
    assert record['failed'] == 0
    read = {name: spec.load_module('metrics', name).read for name in METRICS}
    pct = read['entry_host_pct.istdp'](record)
    assert 0 < pct <= 100
    assert record['entry_host_s'] <= record['traced_seconds']
    assert record['plastic_updates'] > 0
    # the device's metrics read nothing from a CPU run, nor the kernel's
    # rate without the kernel in the trace, nor the phases
    assert record['istdp_kernel_s'] is None
    for name in METRICS:
        if name != 'entry_host_pct.istdp':
            assert read[name](record) is None, name
    ops, nbytes = record['traced_work']
    assert ops > 28 * 1000 * 300 and nbytes > 0


@pytest.fixture
def tracing_off():
    tracing.disable()
    yield
    tracing.enable()   # a new, empty session
    tracing.disable()


@pytest.mark.parametrize('phase', PHASES)
def test_the_phase_readers_read_the_clocks_of_a_card(tracing_off, phase):
    """A session with the iSTDP instance's phase counts (as a traced run on
    a card leaves it): each reader the phase's ns over the warps' steps, in
    µs; nothing off the card."""
    read = spec.load_module('metrics', f'{phase}_us_per_step.istdp').read
    ns = [4_000_000 * (k + 1) + 3 for k in range(len(PHASES))]
    tracing.enable()
    tracing.count_phases('IstdpNet', ns, PHASES, 3168 * 10_000)
    tracing.disable()
    card = dict(platform='gpu', trace=object())
    k = PHASES.index(phase)
    assert read(card) == pytest.approx(ns[k] / (3168 * 10_000) / 1e3,
                                       rel=1e-12)
    assert read(dict(card, platform='cpu')) is None


def test_plastic_updates_per_us_reads_the_counters_over_the_kernels_time():
    read = spec.load_module('metrics', 'plastic_updates_per_us.istdp').read
    assert read(dict(plastic_updates=None, istdp_kernel_s=0.5)) is None
    assert read(dict(plastic_updates=10, istdp_kernel_s=None)) is None
    assert read(dict(platform='gpu')) is None
    assert read(dict(plastic_updates=3_000_000, istdp_kernel_s=0.001)) == 3000


def test_a_program_without_the_entry_stops_before_set_up(monkeypatch):
    monkeypatch.delattr(bt, 'IstdpNet')
    drawn = []
    monkeypatch.setattr(REF, 'make_inputs',
                        lambda *a, **k: drawn.append(1))
    with pytest.raises(AttributeError, match='IstdpNet'):
        measure()
    assert drawn == []


def _altered(monkeypatch, change):
    original = bt.IstdpNet.run

    def altered(self, n_steps, state=None):
        return change(original(self, n_steps, state=state))
    monkeypatch.setattr(bt.IstdpNet, 'run', altered)


def control(monkeypatch):
    """The reference in bfloat16 in the program's place."""
    def run_control(self, n_steps, state=None):
        inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
        out = REF.simulate(CFG, TRIALS, inputs, state._asdict(), n_steps,
                           dtype=torch.bfloat16)
        return state._replace(step=state.step + n_steps, **out)
    monkeypatch.setattr(bt.IstdpNet, 'run', run_control)


def _next_float(x: torch.Tensor, i: int) -> torch.Tensor:
    x = x.clone()
    x[i] = torch.nextafter(x[i], torch.tensor(float('inf')))
    return x


def v_ulp(monkeypatch):
    """The first neuron's v, one ulp up."""
    _altered(monkeypatch, lambda out: out._replace(v=_next_float(out.v, 0)))


def weight_ulp(monkeypatch):
    """The first I -> E weight, one ulp up."""
    _altered(monkeypatch, lambda out: out._replace(
        weights=_next_float(out.weights, 0)))


def missing_spike(monkeypatch):
    """The first neuron that spiked, short one spike."""
    def change(out):
        count = out.spike_count.clone()
        count[int(torch.nonzero(count)[0])] -= 1
        return out._replace(spike_count=count)
    _altered(monkeypatch, change)


@pytest.mark.parametrize('fault', [control, v_ulp, weight_ulp,
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
    for k in ('v', 'g_ampa', 'g_gaba', 'weights', 'apre', 'apost'):
        assert values[f'{k}_mismatch'] > 0, values


def test_the_work_by_hand():
    """Three E and two I neurons: static rows 0 -> (1, 3), 1 -> (), 2 ->
    (0, 1, 4), 3 -> (4), 4 -> (); plastic rows 3 -> (0, 2), 4 -> (2)."""
    work = spec.load_module('work', 'vogels_istdp')
    net = dict(plastic_ptr=torch.tensor([0, 2, 3], dtype=torch.int32),
               static_ptr=torch.tensor([3, 5, 5, 8, 9, 9],
                                       dtype=torch.int32),
               targets=torch.tensor([0, 2, 2, 1, 3, 0, 1, 4, 4],
                                    dtype=torch.int32),
               weights=torch.ones(3))
    inputs = dict(num=5, ne=3, net=net)
    out = dict(spike_count=torch.tensor([2, 0, 1, 3, 1], dtype=torch.int32))
    total = work.reduce(CFG, inputs, out) + work.reduce(CFG, inputs, out)
    # a trial: deliveries 2*2 + 1*3 + 3*(1 + 2) + 1*1, pre updates 3*2 +
    # 1*1, post updates 2*1 + 1*2 (E neuron 0 has one plastic input, 2
    # two), spikes 7, I spikes 4
    assert total.tolist() == [34, 14, 8, 14, 8]
    ops, nbytes = work.count(CFG, inputs, total, 2, 10)
    assert ops == 28 * 5 * 10 * 2 + 1 * 14 + 1 * 34 + 7 * 14 + 4 * 8
    assert nbytes == ((80 * 5 + 8 * 3) * 2 + 4 * 34 + 8 * 14 + 16 * 8
                      + 8 * 14 + 8 * 8)


def test_the_trials_take_the_initial_states_in_turn():
    """Trials 0 and 3 start from the same initial state (three states), so
    they are one trial; trial 1 is another."""
    driver = spec.load_module('drivers', 'istdp_trials')
    inputs = REF.make_inputs(CFG, TRIALS, SEED, CPU)
    system = driver.System(CFG, TRIALS, inputs, CPU)
    a, b, c = system.trial(0, 40), system.trial(3, 40), system.trial(1, 40)
    for k in driver.FIELDS:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a['v'], c['v'])
    assert a['step'] == 40
