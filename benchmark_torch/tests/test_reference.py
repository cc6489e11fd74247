"""Each plain reference against the program's CPU twins at small sizes:
bit for bit, where the twins are."""

import pytest
import torch

import brainevent_torch as bt
from benchmark_torch.harness import spec
from benchmark_torch.reference import lif_ei

from _tiny import SEED

CPU = torch.device('cpu')


def program_state(cls, s):
    return cls(neurons=bt.LIFRefState(v=s['v'], t_last=s['t_last']),
               g_e=s['g_e'], g_i=s['g_i'], spike_count=s['spike_count'])


def fields(out):
    return dict(v=out.neurons.v, t_last=out.neurons.t_last, g_e=out.g_e,
                g_i=out.g_i, spike_count=out.spike_count)


# CUBA's rest lies 6 mV above the initial mean, not 15: its neurons take
# longer to their first spike, and its trial is longer to spike as much
@pytest.mark.parametrize('config, n_steps', [('coba_ei', 400),
                                             ('cuba_ei', 800)])
@pytest.mark.parametrize('scale', [0.25, 1.0])
def test_ei_reference_is_the_program_bit_for_bit(config, n_steps, scale):
    cfg = spec.load_part('configs', config)
    ref = spec.load_module('reference', config)
    inputs = ref.make_inputs(cfg, dict(scale=scale, initial_states=2),
                             SEED, CPU)
    net = bt.EINet(scale=scale, **cfg['network'], conn_all=inputs['conn'],
                   device=CPU)
    state = inputs['states'][1]
    got = fields(net.run(n_steps, inp=cfg['drive']['inp'],
                         state=program_state(bt.EINetState, state)))
    want = ref.simulate(cfg, {}, inputs, state, n_steps)
    assert int(want['spike_count'].sum()) > net.num // 2
    assert ref.compare(cfg, inputs, got, want) == {
        f'{k}_mismatch': 0 for k in lif_ei.FIELDS}


@pytest.mark.parametrize('scale', [0.25, 0.5])
def test_jitc_matrix_is_the_programs(scale):
    cfg = spec.load_part('configs', 'jitc_coba_ei')
    ref = spec.load_module('reference', 'jitc_coba_ei')
    net = bt.JITCNet(scale=scale, **cfg['network'], seed=SEED, device=CPU)
    inputs = dict(net_seed=SEED, n_exc=net.n_exc, num=net.num, device=CPU)
    m = ref.matrix(cfg, inputs)
    for proj, conn, n_pre in (('e', net.conn_e, net.n_exc),
                              ('i', net.conn_i, net.n_inh)):
        dense = torch.zeros(n_pre, net.num)
        dense[m[proj]['rows'], m[proj]['cols']] = m[proj]['w']
        assert torch.equal(dense, conn.todense())
        assert torch.equal(m[proj]['out_degree'],
                           (conn.todense() != 0).sum(1))


def test_jitc_reference_is_the_program_on_the_cpu():
    cfg = spec.load_part('configs', 'jitc_coba_ei')
    ref = spec.load_module('reference', 'jitc_coba_ei')
    inputs = ref.make_inputs(cfg, dict(scale=0.25, initial_states=1), SEED,
                             CPU)
    net = bt.JITCNet(scale=0.25, **cfg['network'], **inputs['program'],
                     device=CPU)
    state = inputs['states'][0]
    got = fields(net.run(300, inp=cfg['drive']['inp'],
                         state=program_state(bt.JITCNetState, state)))
    want = ref.simulate(cfg, {}, inputs, state, 300)
    # the CPU adds a step's inputs in one order, so the twins are the
    # reference bit for bit here; the card's atomics are not
    assert lif_ei.bit_mismatches(got, want) == {
        f'{k}_mismatch': 0 for k in lif_ei.FIELDS}
    assert ref.compare(cfg, inputs, got, want) == dict(
        spikes_gap_e=0.0, spikes_gap_i=0.0)


@pytest.mark.parametrize('cap', [1, 7, 40, 1000])
def test_coba_ei_compaction_at_any_cap(cap):
    """The card's static-shape propagation: the hits of at most *cap*
    spikes, the count of them all, whatever the cap."""
    cfg = spec.load_part('configs', 'coba_ei')
    ref = spec.load_module('reference', 'coba_ei')
    inputs = ref.make_inputs(cfg, dict(scale=0.25, initial_states=1), SEED,
                             CPU)
    conn, n_exc, num = inputs['conn'], inputs['n_exc'], inputs['num']
    p = lif_ei.params(cfg)
    spike = torch.zeros(num, dtype=torch.bool)
    spike[torch.randperm(num, generator=torch.Generator().manual_seed(1))
          [:40]] = True
    e, i, n = ref.propagation(conn, n_exc, p, cap)(spike)
    ids = torch.nonzero(spike).flatten()[:cap]
    want = torch.zeros(2 * num)
    for k in ids.tolist():
        for t in conn[k].tolist():
            want[t + (num if k >= n_exc else 0)] += 1
    assert int(n) == 40
    assert torch.equal(e, p.w_e * want[:num])
    assert torch.equal(i, p.w_i * want[num:])
