# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Surrogate-gradient training of brainevent_torch against brainevent_tpu.

The JAX ``SurrogateSNN(n_in=12, n_hidden=128, n_out=4, n_conn=8, seed=3)``
(the model of ``tests/test_models.py``) is carried across with
``surrogate_snn_from_arrays``, and both packages run it on the same inputs
on the CPU: the JAX one through its Pallas kernels in interpret mode, the
port through the twins of K3, K4 and K5. The forward arithmetic is the
same, so the spike trains must be equal; the logits are held to rtol 1e-5
(the readout and input products are matmuls summed in another order).
Gradients and parameters after training are held to the JAX package's own
bands, rtol 1e-4 and atol 1e-6 (``tests/test_models.py``): autograd sums
the per-step weight gradients in another order than JAX's scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.models import training as tt
from brainevent_tpu.models import training as jt
from brainevent_tpu.models.neurons import surrogate_spike as jax_spike

from _torch_one_thread import one_torch_thread  # noqa: F401

KW = dict(n_in=12, n_hidden=128, n_out=4, n_conn=8, seed=3)
T, LABEL = 20, 1
RTOL, ATOL = 1e-4, 1e-6


def _inputs(seed=0, n_steps=T):
    return np.random.default_rng(seed).random((n_steps, 12)).astype(
        np.float32)


def _jax_spikes(model, params, x):
    """``brainevent_tpu``'s ``SurrogateSNN.run`` with the spike trains
    returned (the same steps; its logits are checked equal to ``run``)."""
    c = model.consts()
    decay = jnp.float32(jnp.exp(-model.dt / model.tau))
    w_sorted = jt._sorted_view(params.w_rec, c['perm'], c['inv'])
    fwd_w = model._fwd_weights(params.w_rec, c)

    def step(carry, x_t):
        v, spk = carry
        rec = model._rec(c['meta'], c['b0'], c['rb'], c['metaT'], c['b0T'],
                         c['rbT'], c['idx'], w_sorted, fwd_w, spk)
        v = v * decay + (x_t @ params.w_in + rec)
        spk = jax_spike(v - model.v_th)
        return (v - spk * model.v_th, spk), spk

    zeros = jnp.zeros(model.n_hidden)
    return jax.lax.scan(step, (zeros, zeros), jnp.asarray(x))[1]


def _port(jm, forward):
    return bt.surrogate_snn_from_arrays(
        np.asarray(jm.rec_indices), *(np.asarray(a) for a in jm.init_params()),
        forward=forward, device='cpu')


@pytest.fixture(scope='module', params=['plan', 'event'])
def pair(request):
    forward = request.param
    jm = jt.SurrogateSNN(**KW, forward=forward)
    model, params = _port(jm, forward)
    return forward, jm, model, params


def test_spike_trains_and_logits_match_jax(pair):
    _, jm, model, params = pair
    x = _inputs()
    jp = jm.init_params()
    jax_spikes = _jax_spikes(jm, jp, x)
    want_spikes = np.asarray(jax_spikes)
    want_logits = np.asarray(jm.run(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jax_spikes.mean(0) @ jp.w_out),
                                  want_logits)
    assert 0.01 < want_spikes.mean() < 0.5
    spikes = model._spikes(params, torch.from_numpy(x))
    np.testing.assert_array_equal(spikes.numpy(), want_spikes)
    logits = model.run(params, torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-5)


def test_loss_and_grads_match_jax(pair):
    _, jm, model, params = pair
    x = _inputs(1)
    jp = jm.init_params()
    want_loss, want = jax.value_and_grad(
        lambda p: jt.snn_loss(jm, p, jnp.asarray(x), jnp.asarray(LABEL)))(jp)
    leaves = [p.clone().requires_grad_(True) for p in params]
    loss = bt.snn_loss(model, bt.SNNParams(*leaves), torch.from_numpy(x),
                       LABEL)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for name, g, w in zip(bt.SNNParams._fields, grads, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_train_steps_track_jax(pair):
    forward, jm, model, params = pair
    x = jnp.asarray(_inputs(2))
    step = jax.jit(lambda p: jt.train_step(jm, p, x, jnp.asarray(LABEL),
                                           lr=1e-2))
    jp, tp = jm.init_params(), params
    xs = torch.from_numpy(np.array(x))
    for _ in range(10):
        jp, jloss = step(jp)
        tp, tloss = bt.train_step(model, tp, xs, LABEL, lr=1e-2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name, a, b in zip(bt.SNNParams._fields, tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_second_train_step_grads_track_jax(pair):
    """The gradients of the second train step against the JAX package's:
    the backward's row-order weight view is made from the updated
    weights, not kept from the first step."""
    _, jm, model, params = pair
    x = _inputs(7)
    xj, label = jnp.asarray(x), jnp.asarray(LABEL)
    jp, _ = jt.train_step(jm, jm.init_params(), xj, label, lr=0.5)
    want = jax.grad(lambda p: jt.snn_loss(jm, p, xj, label))(jp)
    tp, _ = bt.train_step(model, params, torch.from_numpy(x), LABEL, lr=0.5)
    leaves = [p.clone().requires_grad_(True) for p in tp]
    loss = bt.snn_loss(model, bt.SNNParams(*leaves), torch.from_numpy(x),
                       LABEL)
    grads = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(bt.SNNParams._fields, grads, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_event_forward_same_grads_as_plan():
    jm = jt.SurrogateSNN(**KW)
    x = torch.from_numpy(_inputs(3, 8))
    grads = {}
    for forward in ('plan', 'event'):
        model, params = _port(jm, forward)
        leaves = [p.clone().requires_grad_(True) for p in params]
        loss = bt.snn_loss(model, bt.SNNParams(*leaves), x, 0)
        grads[forward] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads['plan'], grads['event']):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_plan_train_step_repeats_bitwise():
    model = bt.SurrogateSNN(**KW, device='cpu')
    x = torch.from_numpy(_inputs(4))
    a = bt.train_step(model, model.init_params(), x, 2)
    b = bt.train_step(model, model.init_params(), x, 2)
    assert torch.equal(a[1], b[1])
    assert all(torch.equal(p, q) for p, q in zip(a[0], b[0]))


def test_sorted_view_roundtrip_and_grad():
    model = bt.SurrogateSNN(**KW, device='cpu')
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=(128, 8)).astype(np.float32)).requires_grad_(True)
    c = model.consts()
    ws = tt._sorted_view(w, c['perm'], c['inv'])
    np.testing.assert_array_equal(ws.reshape(-1)[c['inv'].long()].detach(),
                                  w.detach().reshape(-1))
    assert (ws[c['perm'] < 0] == 0).all()
    # the backward is the inverse-perm gather: each weight appears once
    (g,) = torch.autograd.grad(ws.sum(), w)
    np.testing.assert_array_equal(g.numpy(), 1.0)
    jm = jt.SurrogateSNN(**KW)
    jc = jm.consts()
    jw = jnp.asarray(w.detach().numpy())
    port, _ = _port(jm, 'plan')
    np.testing.assert_array_equal(
        tt._sorted_view(w, port.consts()['perm'],
                        port.consts()['inv']).detach().numpy(),
        np.asarray(jt._sorted_view(jw, jc['perm'], jc['inv'])))


def test_own_init_shapes_and_scales():
    model = bt.SurrogateSNN(n_in=40, n_hidden=2000, n_out=4, n_conn=32,
                            seed=1, device='cpu')
    p = model.init_params()
    assert p.w_in.shape == (40, 2000) and p.w_rec.shape == (2000, 32)
    assert p.w_out.shape == (2000, 4)
    for w, std in ((p.w_in, 0.1), (p.w_rec, 0.5 / 32 ** 0.5),
                   (p.w_out, 0.1)):
        assert w.dtype == torch.float32
        assert abs(float(w.std()) / std - 1) < 0.05
        assert abs(float(w.mean())) < 0.05 * std
    idx = model.rec_indices
    assert idx.shape == (2000, 32) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 2000
    again = bt.SurrogateSNN(n_in=40, n_hidden=2000, n_out=4, n_conn=32,
                            seed=1, device='cpu')
    assert torch.equal(again.rec_indices, idx)
    assert all(torch.equal(a, b) for a, b in zip(again.init_params(), p))
    other = bt.SurrogateSNN(n_in=40, n_hidden=2000, n_out=4, n_conn=32,
                            seed=2, device='cpu')
    assert not torch.equal(other.rec_indices, idx)


def test_consts_spike_counts_and_bad_arrays():
    model = bt.SurrogateSNN(**KW, device='cpu')
    assert set(model.consts()) == set(jt.SurrogateSNN(**KW).consts())
    x = torch.from_numpy(_inputs(6, 4))
    assert float(model.spike_counts(model.init_params(), x)) == 0.0
    p = model.init_params()
    with pytest.raises(ValueError, match='do not fit'):
        bt.surrogate_snn_from_arrays(np.zeros((128, 7), np.int32),
                                     *(a.numpy() for a in p),
                                     device='cpu')
    with pytest.raises(ValueError, match='forward'):
        bt.SurrogateSNN(**KW, forward='dense', device='cpu')
