# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The port's dense slice against the JAX package on the CPU.

The same numpy inputs go through ``brainevent_tpu`` and the port's twins:
the event products (``binary_densemv``/``binary_densemm``, both
directions) and their gradients within ``1e-5 * sum|W| * gate`` per
output (the two sum in other orders); the STDP updates, clip included,
bitwise (the gate is 0 or 1, so each entry is one rounding either way);
the ``Dense`` surface and ``dense_from_arrays``. The JAX Pallas kernels
run in interpret mode, once per kernel and direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
import brainevent_tpu as be
from brainevent_torch.dense import pallas_kernels as dk

from _torch_one_thread import one_torch_thread  # noqa: F401

M, K, B = 200, 300, 16
RATES = (0.0, 0.05, 1.0)
KINDS = ('bool', 'float', 'int')
_RNG = np.random.default_rng(20260916)
W = _RNG.normal(size=(M, K)).astype(np.float32)


def _spikes(shape, rate, kind, seed):
    """Spikes at *rate*: bool; float with values in (0.5, 2) on the
    active entries and zeros, negatives and NaN on the silent ones (so the
    products' ``> 0`` gate and STDP's ``!= 0`` gate differ); or int."""
    rng = np.random.default_rng(seed)
    on = rng.random(shape) < rate
    if kind == 'bool':
        return on
    if kind == 'int':
        return np.where(on, rng.integers(1, 4, shape),
                        -rng.integers(0, 3, shape)).astype(np.int32)
    x = np.where(on, rng.uniform(0.5, 2.0, shape),
                 -rng.uniform(0.0, 1.0, shape)).astype(np.float32)
    silent = rng.random(shape)
    x[(~on) & (silent < 0.2)] = np.nan
    x[(~on) & (silent > 0.5)] = 0.0
    return x


def _gate(s):
    return (s if s.dtype == bool else s > 0).astype(np.float64)


def _close(got, want, bound, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    assert got.shape == np.shape(want), what
    assert (err <= 1e-5 * bound + 1e-30).all(), (what, err.max())


def _mv_case(transpose, rate, kind, seed=1):
    n = M if transpose else K
    return _spikes((n,), rate, kind, seed)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('rate', RATES)
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_densemv_matches_jax(transpose, rate, kind):
    s = _mv_case(transpose, rate, kind)
    want = be.binary_densemv(jnp.asarray(W), jnp.asarray(s),
                             transpose=transpose, backend='jax_raw')
    got = bt.binary_densemv(torch.from_numpy(W), torch.from_numpy(s),
                            transpose=transpose)
    g = _gate(s)
    bound = g @ np.abs(W) if transpose else np.abs(W) @ g
    _close(got, want, bound, (transpose, rate, kind))
    # the gate: the bare weight of every active spike
    _close(got, g @ W if transpose else W @ g, bound)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('rate', RATES)
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_densemm_matches_jax(transpose, rate, kind):
    S = _spikes((M if transpose else K, B), rate, kind, 2)
    want = be.binary_densemm(jnp.asarray(W), jnp.asarray(S),
                             transpose=transpose, backend='jax_raw')
    got = bt.binary_densemm(torch.from_numpy(W), torch.from_numpy(S),
                            transpose=transpose)
    g = _gate(S)
    bound = np.abs(W).T @ g if transpose else np.abs(W) @ g
    _close(got, want, bound, (transpose, rate, kind))


@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_products_match_interpreted_pallas(transpose):
    """One call per TPU kernel and direction in interpret mode."""
    s = _mv_case(transpose, 0.05, 'float')
    S = _spikes((M if transpose else K, B), 0.05, 'bool', 3)
    got = bt.binary_densemv(torch.from_numpy(W), torch.from_numpy(s),
                            transpose=transpose)
    want = be.binary_densemv(jnp.asarray(W), jnp.asarray(s),
                             transpose=transpose, backend='pallas')
    g = _gate(s)
    _close(got, want, g @ np.abs(W) if transpose else np.abs(W) @ g)
    got = bt.binary_densemm(torch.from_numpy(W), torch.from_numpy(S),
                            transpose=transpose)
    want = be.binary_densemm(jnp.asarray(W), jnp.asarray(S),
                             transpose=transpose, backend='pallas')
    g = _gate(S)
    _close(got, want, (np.abs(W).T if transpose else np.abs(W)) @ g)


@pytest.mark.parametrize('mm', [False, True], ids=['mv', 'mm'])
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_grads_match_jax(transpose, mm):
    n = M if transpose else K
    s = _spikes((n, B) if mm else (n,), 0.3, 'float', 4)
    s = np.nan_to_num(s)                     # a NaN would poison ds
    out_shape = ((K if transpose else M), B) if mm else (K if transpose
                                                         else M,)
    ct = np.random.default_rng(5).normal(size=out_shape).astype(np.float32)
    fn_j = be.binary_densemm if mm else be.binary_densemv
    fn_t = bt.binary_densemm if mm else bt.binary_densemv

    def loss(w, x):
        return (fn_j(w, x, transpose=transpose) * jnp.asarray(ct)).sum()

    jw, js = jax.grad(loss, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(s))
    w = torch.from_numpy(W).requires_grad_(True)
    x = torch.from_numpy(s).requires_grad_(True)
    tw, ts = torch.autograd.grad(fn_t(w, x, transpose=transpose),
                                 (w, x), torch.from_numpy(ct))
    # dW pairs the gate with the cotangent: one product per entry for a
    # vector, a sum over the batch for a matrix
    g = _gate(s)
    if mm:
        w_bound = g @ np.abs(ct).T if transpose else np.abs(ct) @ g.T
        _close(tw, jw, w_bound)
    else:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    bound = (np.abs(W) @ np.abs(ct) if transpose
             else np.abs(W).T @ np.abs(ct))
    _close(ts, js, bound)
    # bool spikes get no gradient; the weights still do, the same one
    sb = torch.from_numpy(s > 0)
    (tw2,) = torch.autograd.grad(fn_t(w, sb, transpose=transpose), (w,),
                                 torch.from_numpy(ct))
    np.testing.assert_array_equal(tw2.numpy(), tw.numpy())


def test_shape_checks_raise():
    w, s = torch.from_numpy(W), torch.zeros(K, dtype=torch.bool)
    with pytest.raises(bt.MathError):
        bt.binary_densemv(w, s, transpose=True)      # needs length M
    with pytest.raises(bt.MathError):
        bt.binary_densemv(w[0], s, transpose=False)
    with pytest.raises(bt.MathError):
        bt.binary_densemm(w, s[:, None], transpose=True)
    with pytest.raises(bt.MathError):
        bt.update_dense_on_binary_pre(w, s, torch.zeros(K))
    with pytest.raises(bt.MathError):
        bt.BinaryArray(s) @ w                          # (300,) @ (200, 300)
    with pytest.raises(bt.MathError):
        bt.BinaryArray(torch.zeros(2, 2, 2)) @ w


# -- STDP ------------------------------------------------------------------------

_W0 = (_RNG.normal(size=(M, K)) * 0.8).astype(np.float32)   # partly outside
CLIPS = [(None, None), (-0.75, 0.75), (None, 0.5), (-0.5, None)]


@pytest.mark.parametrize('clip', CLIPS, ids=str)
@pytest.mark.parametrize('kind', KINDS)
def test_stdp_bitwise_against_jax(kind, clip):
    rng = np.random.default_rng(6)
    pre, post = _spikes((M,), 0.2, kind, 7), _spikes((K,), 0.2, kind, 8)
    t_post = rng.normal(size=K).astype(np.float32)
    t_pre = rng.normal(size=M).astype(np.float32)
    jw = be.update_dense_on_binary_pre(jnp.asarray(_W0), jnp.asarray(pre),
                                       jnp.asarray(t_post), *clip,
                                       backend='jax_raw')
    jw = be.update_dense_on_binary_post(jw, jnp.asarray(t_pre),
                                        jnp.asarray(post), *clip,
                                        backend='jax_raw')
    tw = bt.update_dense_on_binary_pre(torch.from_numpy(_W0),
                                       torch.from_numpy(pre),
                                       torch.from_numpy(t_post), *clip)
    tw = bt.update_dense_on_binary_post(tw, torch.from_numpy(t_pre),
                                        torch.from_numpy(post), *clip)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # the != 0 gate: NaN and negative spikes count
    nz = (pre if pre.dtype == bool else pre != 0).astype(np.float32)
    ref = _W0 + np.outer(nz, t_post)
    if clip != (None, None):
        ref = np.clip(ref, *clip)
    np.testing.assert_array_equal(
        bt.update_dense_on_binary_pre(torch.from_numpy(_W0),
                                      torch.from_numpy(pre),
                                      torch.from_numpy(t_post),
                                      *clip).numpy(), ref)


def test_stdp_matches_interpreted_pallas():
    rng = np.random.default_rng(9)
    pre, post = _spikes((M,), 0.2, 'float', 10), _spikes((K,), 0.2, 'bool', 11)
    t_post = rng.normal(size=K).astype(np.float32)
    t_pre = rng.normal(size=M).astype(np.float32)
    for fn_j, fn_t, args in (
            (be.update_dense_on_binary_pre, bt.update_dense_on_binary_pre,
             (pre, t_post)),
            (be.update_dense_on_binary_post, bt.update_dense_on_binary_post,
             (t_pre, post))):
        want = fn_j(jnp.asarray(_W0), *map(jnp.asarray, args), -0.75, 0.75,
                    backend='pallas')
        got = fn_t(torch.from_numpy(_W0), *map(torch.from_numpy, args),
                   -0.75, 0.75)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('clip', [(None, None), (-0.75, 0.75)], ids=str)
def test_stdp_weight_grad_is_identity_then_clip(clip):
    rng = np.random.default_rng(12)
    pre, t = _spikes((M,), 0.3, 'bool', 13), rng.normal(size=K).astype(
        np.float32)
    ct = rng.normal(size=(M, K)).astype(np.float32)

    def loss(w):
        return (be.update_dense_on_binary_pre(w, jnp.asarray(pre),
                                              jnp.asarray(t), *clip)
                * jnp.asarray(ct)).sum()

    want = jax.grad(loss)(jnp.asarray(_W0))
    w = torch.from_numpy(_W0).requires_grad_(True)
    out = bt.update_dense_on_binary_pre(w, torch.from_numpy(pre),
                                        torch.from_numpy(t), *clip)
    (got,) = torch.autograd.grad(out, (w,), torch.from_numpy(ct))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the Dense surface -------------------------------------------------------------

def test_dense_surface_matches_jax():
    rng = np.random.default_rng(14)
    w = ((rng.random((60, 45)) < 0.3) * rng.normal(size=(60, 45))).astype(
        np.float32)
    J = be.Dense(jnp.asarray(w))
    T = bt.dense_from_arrays(np.asarray(J.data), device='cpu')
    assert isinstance(T, bt.Dense) and T.shape == J.shape == (60, 45)
    assert T.nse == J.nse and T.dtype == torch.float32
    np.testing.assert_array_equal(T.todense().numpy(), w)
    np.testing.assert_array_equal(bt.Dense.fromdense(T.data).data.numpy(), w)
    np.testing.assert_array_equal(T.T.todense().numpy(), np.asarray(J.T.data))
    np.testing.assert_array_equal(T.slice_rows(slice(3, 9)).data.numpy(),
                                  np.asarray(J.slice_rows(slice(3, 9)).data))
    for other in (1.5, rng.normal(size=45).astype(np.float32)):
        np.testing.assert_array_equal(
            T.diag_add(torch.as_tensor(other)).data.numpy(),
            np.asarray(J.diag_add(jnp.asarray(other)).data))
    assert torch.equal(T.data, torch.from_numpy(w))   # diag_add out of place
    np.testing.assert_array_equal((T * 2.0).data.numpy(),
                                  np.asarray((J * 2.0).data))
    np.testing.assert_array_equal((1.0 - T).data.numpy(),
                                  np.asarray((1.0 - J).data))
    np.testing.assert_array_equal((T + T).data.numpy(),
                                  np.asarray((J + J).data))
    np.testing.assert_array_equal(T.apply(torch.abs).data.numpy(), np.abs(w))
    y = rng.normal(size=60).astype(np.float32)
    z = rng.normal(size=45).astype(np.float32)
    np.testing.assert_array_equal(T.dt2t(torch.from_numpy(y)).numpy(),
                                  np.asarray(J.dt2t(jnp.asarray(y))))
    np.testing.assert_array_equal(
        T.dt2t_transposed(torch.from_numpy(z)).numpy(),
        np.asarray(J.dt2t_transposed(jnp.asarray(z))))
    with pytest.raises(bt.MathError):
        T.with_data(torch.ones(3, 3))
    assert torch.equal(T.with_data(torch.ones(60, 45)).data, torch.ones(60, 45))
    # CSR and CSC conversions: the JAX structure bitwise
    for tc, jc in ((T.tocsr(), J.tocsr()), (T.tocsc(), J.tocsc())):
        for name in ('data', 'indices', 'indptr'):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))
    with pytest.raises(bt.UnsupportedOperationError, match='ROADMAP.md'):
        T.tocoo()
    a = (rng.normal(size=(5, 5)) + 5 * np.eye(5)).astype(np.float32)
    np.testing.assert_allclose(
        bt.Dense(torch.from_numpy(a)).solve(torch.ones(5)).numpy(),
        np.asarray(be.Dense(jnp.asarray(a)).solve(jnp.ones(5))),
        rtol=1e-5, atol=1e-6)


def test_dense_products_and_stdp_methods_match_jax():
    J = be.Dense(jnp.asarray(W))
    T = bt.Dense(torch.from_numpy(W))
    s_k, s_m = _spikes((K,), 0.1, 'bool', 15), _spikes((M,), 0.1, 'float', 16)
    S_k, S_m = _spikes((K, B), 0.1, 'bool', 17), _spikes((B, M), 0.1, 'bool',
                                                         18)
    X = np.random.default_rng(19).normal(size=(K, 3)).astype(np.float32)
    pairs = [
        (J @ be.BinaryArray(jnp.asarray(s_k)),
         T @ bt.BinaryArray(torch.from_numpy(s_k)), np.abs(W) @ _gate(s_k)),
        (be.BinaryArray(jnp.asarray(s_m)) @ J,
         bt.BinaryArray(torch.from_numpy(s_m)) @ T, _gate(s_m) @ np.abs(W)),
        (J @ be.BinaryArray(jnp.asarray(S_k)),
         T @ bt.CompactBinary.from_array(torch.from_numpy(S_k)),
         np.abs(W) @ _gate(S_k)),
        (be.BinaryArray(jnp.asarray(S_m)) @ J,
         bt.CompactBinary.from_array(torch.from_numpy(S_m)) @ T,
         _gate(S_m) @ np.abs(W)),
        (J @ jnp.asarray(X), T @ torch.from_numpy(X), np.abs(W) @ np.abs(X)),
        (jnp.asarray(X.T) @ J.T, torch.from_numpy(X.T) @ T.T,
         np.abs(X.T) @ np.abs(W.T)),
    ]
    for want, got, bound in pairs:
        _close(got, want, bound)
    rng = np.random.default_rng(20)
    t_k, t_m = rng.normal(size=K).astype(np.float32), rng.normal(
        size=M).astype(np.float32)
    post = _spikes((K,), 0.2, 'float', 21)
    for pre in (bt.BinaryArray(torch.from_numpy(s_m)),
                bt.CompactBinary.from_array(torch.from_numpy(s_m)),
                torch.from_numpy(s_m)):
        got = T.update_on_pre(pre, torch.from_numpy(t_k), -1.0, 1.0)
        got = got.update_on_post(torch.from_numpy(t_m),
                                 bt.BinaryArray(torch.from_numpy(post)),
                                 -1.0, 1.0)
        want = J.update_on_pre(be.BinaryArray(jnp.asarray(s_m)),
                               jnp.asarray(t_k), -1.0, 1.0)
        want = want.update_on_post(jnp.asarray(t_m),
                                   be.BinaryArray(jnp.asarray(post)),
                                   -1.0, 1.0)
        assert isinstance(got, bt.Dense)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_dense_products_route_through_the_dense_ops(monkeypatch):
    """Every ``@`` with an event operand reaches K15 or K16 (on the CPU,
    their twins): counted by wrapping the ops' twins."""
    calls = []
    for op in (dk.dense_event_mv, dk.dense_event_mm):
        twin = op.twin
        monkeypatch.setattr(op, 'twin', lambda *a, _t=twin, _n=op.name: (
            calls.append(_n), _t(*a))[1])
    w = torch.from_numpy(W)
    s_m, s_k = torch.rand(M) < 0.3, torch.rand(K) < 0.3
    S_m, S_k = torch.rand(4, M) < 0.3, torch.rand(K, 4) < 0.3
    D = bt.Dense(w)
    for expr, name in (
            (lambda: bt.BinaryArray(s_m) @ w, 'dense_event_mv'),
            (lambda: w @ bt.BinaryArray(s_k), 'dense_event_mv'),
            (lambda: bt.BinaryArray(S_m) @ w, 'dense_event_mm'),
            (lambda: w @ bt.BinaryArray(S_k), 'dense_event_mm'),
            (lambda: bt.BitPackedBinary(s_m) @ w, 'dense_event_mv'),
            (lambda: w @ bt.BitPackedBinary(S_k), 'dense_event_mm'),
            (lambda: bt.CompactBinary.from_array(s_m) @ w, 'dense_event_mv'),
            (lambda: w @ bt.CompactBinary.from_array(S_k), 'dense_event_mm'),
            (lambda: bt.CompactBinary.from_array(s_m) @ D, 'dense_event_mv'),
            (lambda: D @ bt.BinaryArray(S_k), 'dense_event_mm'),
            (lambda: bt.BinaryArray(S_m) @ D, 'dense_event_mm')):
        calls.clear()
        expr()
        assert calls == [name]


def test_kernel_wrappers_refuse_other_dtypes():
    """On the card the kernels take float32 or float64 weights and traces
    (float64 through their double instances) and bool or float32 spikes;
    anything else raises a ``TypeError`` before a launch (the wrappers are
    called directly, with CPU tensors)."""
    w = torch.zeros(4, 4)
    s, t = torch.zeros(4, dtype=torch.bool), torch.zeros(4)
    for op, args in (
            (dk.dense_event_mv, (w.half(), s, True)),
            (dk.dense_stdp_pre, (w.double(), s, t, None, None)),
            (dk.dense_event_mv, (w, s.int(), True)),
            (dk.dense_event_mm, (w, torch.zeros(4, 2, dtype=torch.int8),
                                 False)),
            (dk.dense_stdp_pre, (w, s.double(), t, None, None)),
            (dk.dense_stdp_post, (w, t.half(), s, None, None))):
        with pytest.raises(TypeError):
            op.cuda(op, *args)
    from brainevent_torch.events import pallas_kernels as ek
    with pytest.raises(TypeError):
        ek.event_row_count.cuda(ek.event_row_count,
                                torch.zeros(2, 3, dtype=torch.int32))
