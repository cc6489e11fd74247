"""The comparison that decides ``correct`` fails what it must: the
control (the plain reference in the program's place, computed in
bfloat16, the precision below the configuration's float32) and each
fault a trial can have, planted under the timed path. The harness runs
as on the card but for the look for one: the program runs its CPU
twins, at a small size."""

import time

import pytest
import torch

import brainevent_torch as bt
from benchmark_torch import run
from benchmark_torch.harness import spec
from benchmark_torch.reference import lif_ei

from _tiny import SEED, TRIALS

CPU = torch.device('cpu')
CELLS = {'coba_ei.4k': bt.EINet, 'cuba_ei.400k': bt.EINet,
         'jitc_coba_ei.80k': bt.JITCNet}


def measure(cell):
    return run.measure(cell, SEED, 0.3, False, CPU, time.perf_counter(),
                       traffic=TRIALS)


def program_state(net, fields):
    cls = bt.EINetState if isinstance(net, bt.EINet) else bt.JITCNetState
    return cls(neurons=bt.LIFRefState(v=fields['v'], t_last=fields['t_last']),
               g_e=fields['g_e'], g_i=fields['g_i'],
               spike_count=fields['spike_count'])


def fields(state):
    return dict(v=state.neurons.v, t_last=state.neurons.t_last, g_e=state.g_e,
                g_i=state.g_i, spike_count=state.spike_count)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    record = measure(cell)
    assert record['checked'] >= 1 and record['failed'] == 0, record


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_the_control_is_not_correct(cell, monkeypatch):
    config = spec.load_part('workloads', cell)['config']
    cfg = spec.load_part('configs', config)
    ref = spec.load_module('reference', config)

    def control(self, n_steps, inp, state):
        inputs = ref.make_inputs(cfg, TRIALS, SEED, CPU)
        out = ref.simulate(cfg, TRIALS, inputs, fields(state), n_steps,
                           dtype=torch.bfloat16)
        return program_state(self, out)
    monkeypatch.setattr(CELLS[cell], 'run', control)
    record = measure(cell)
    assert record['failed'] == record['checked'] >= 1


def unchanged(monkeypatch, cls):
    """A trial that returns its initial state."""
    monkeypatch.setattr(cls, 'run', lambda self, n, inp, state: state)


def no_input(monkeypatch, cls):
    """Spikes that reach no target: the synaptic input left out where it
    is produced."""
    if cls is bt.EINet:
        from brainevent_torch.models import networks
        monkeypatch.setattr(networks, 'event_count_scatter_twin',
                            lambda *args: None)
    else:
        monkeypatch.setattr(
            cls, '_propagate',
            lambda self, spike: (torch.zeros(self.num), torch.zeros(self.num)))


def one_entry(monkeypatch, cls):
    """One entry of the answer altered: neuron 0's membrane by one ulp."""
    original = cls.run

    def altered(self, n, inp, state):
        out = original(self, n, inp=inp, state=state)
        v = out.neurons.v.clone()
        v[0] = torch.nextafter(v[0], torch.tensor(0.0))
        return out._replace(neurons=out.neurons._replace(v=v))
    monkeypatch.setattr(cls, 'run', altered)


def lost_spikes(monkeypatch, cls):
    """Each neuron's count short by its last spike."""
    original = cls.run

    def altered(self, n, inp, state):
        out = original(self, n, inp=inp, state=state)
        return out._replace(spike_count=torch.clamp(out.spike_count - 1,
                                                    min=0))
    monkeypatch.setattr(cls, 'run', altered)


FAULTS = [(cell, f) for cell in ('coba_ei.4k', 'cuba_ei.400k')
          for f in (unchanged, no_input, one_entry, lost_spikes)]
FAULTS += [('jitc_coba_ei.80k', f) for f in (unchanged, no_input,
                                             lost_spikes)]


@pytest.mark.parametrize('cell, fault', FAULTS,
                         ids=[f'{c}-{f.__name__}' for c, f in FAULTS])
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, CELLS[cell])
    record = measure(cell)
    assert record['failed'] == record['checked'] >= 1
    assert any(v > limit for v, limit in record['checks'].values())
