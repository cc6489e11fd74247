# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Operands the JAX package takes and the kernels of the port do not.

- A numpy array on the left of ``@``: every port class defers to its
  ``__rmatmul__`` (``__array_ufunc__ = None``), which takes the array as a
  tensor; the products equal the JAX package's.
- Dtypes at the public entries of K5-K8, K10, K12, K13 and K15-K18
  (``ops/operand.py``), held against the JAX package's function on the
  same numpy inputs (under ``jax.enable_x64``, so that int64 and float64
  stay what they are): the result dtype equal, and the values within the
  family's float32 bound ``1e-5 * sum|w| gate`` per output (exact for
  STDP and the row count); float16 and bfloat16 weights within 1 ulp of
  the result's dtype on top of that; float64 results within
  ``1e-12 * sum|w| gate``. Spikes of nine dtypes, negatives and NaN among
  them, so the JAX package's gate (``> 0`` for the products, ``!= 0`` for
  STDP and the row count) is checked per family.
- A second check, on what the ops receive (they are wrapped to record
  it): spikes reach them as bool or float32 and give the bool spikes'
  result bitwise; float16 and bfloat16 weights reach them as float32 and
  come back in their dtype, rounded once from the float32 result; float64
  weights reach them as float64, whose twins compute in float64 on the
  CPU (on the card the entries raise; ``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_tpu as be
import brainevent_torch as bt
from brainevent_torch.ops import core

from _torch_one_thread import one_torch_thread  # noqa: F401

F32 = np.float32


# -- numpy on the left of @ -----------------------------------------------------------

def _c7_cases():
    rng = np.random.default_rng(70)
    s = rng.random(6) < 0.5
    S = rng.random((6, 3)) < 0.5
    A = np.where(rng.random((6, 5)) < 0.4, rng.normal(size=(6, 5)), 0).astype(
        F32)
    W = rng.normal(size=(4, 6)).astype(F32)
    v, X = rng.normal(size=6).astype(F32), rng.normal(size=(2, 6)).astype(F32)
    jitc = ((0.6, 0.06, 0.3, 9), dict(shape=(6, 5)))
    return {
        'BinaryArray': (W, lambda m: m.BinaryArray(s)),
        'BinaryArray 2-D': (W, lambda m: m.BinaryArray(S)),
        'BitPackedBinary': (W, lambda m: m.BitPackedBinary(s)),
        'CompactBinary': (W, lambda m: m.CompactBinary.from_array(s)),
        'Dense': (v, lambda m: m.Dense(A)),
        'CSR': (v, lambda m: m.CSR.fromdense(A)),
        'CSR 2-D': (X, lambda m: m.CSR.fromdense(A)),
        'CSC': (v, lambda m: m.CSC.fromdense(A)),
        'JITCNormalR': (v, lambda m: m.JITCNormalR(jitc[0], **jitc[1])),
        'JITCNormalR 2-D': (X, lambda m: m.JITCNormalR(jitc[0], **jitc[1])),
    }


class _T:
    """The port's classes, built from torch tensors on the CPU."""

    def __getattr__(self, name):
        cls = getattr(bt, name)
        if name.startswith('JITC'):
            return lambda data, **kw: cls(data, device='cpu', **kw)
        if name in ('CompactBinary', 'CSR', 'CSC'):
            return cls
        return lambda x: cls(torch.as_tensor(x))


class _J:
    def __getattr__(self, name):
        cls = getattr(be, name)
        if name.startswith('JITC') or name in ('CompactBinary', 'CSR', 'CSC'):
            return cls
        return lambda x: cls(jnp.asarray(x))


@pytest.mark.parametrize('case', sorted(_c7_cases()))
def test_numpy_left_matmul_matches_jax(case):
    left, build = _c7_cases()[case]
    got = left @ build(_T())
    # the JAX package's 1-D ``ndarray @ JITC matrix`` goes through its walk
    # plan, which sets no __array_priority__, and numpy raises: its value
    # is taken with a jax array on the left
    jleft = jnp.asarray(left) if case == 'JITCNormalR' else left
    want = jleft @ build(_J())
    assert isinstance(got, torch.Tensor), type(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_numpy_left_matmul_lands_on_the_objects_device(monkeypatch):
    # the array becomes a tensor on the class's device, never the CPU's
    # default; recorded at the product through a meta-device stand-in
    W = np.ones((3, 4), F32)
    seen = []
    from brainevent_torch.dense import binary as db

    def densemv(weights, spikes, *, transpose):
        seen.append((weights.device, spikes.device))
        return weights.sum(1)
    monkeypatch.setattr(db, 'binary_densemv', densemv)
    s = bt.BinaryArray(torch.ones(4, dtype=torch.bool, device='meta'))
    W @ s
    assert seen == [(torch.device('meta'), torch.device('meta'))]


# -- dtypes at the public entries -------------------------------------------------------

SPIKE_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int32, torch.int64,
                torch.float16, torch.bfloat16, torch.float32, torch.float64)
HALF = (torch.float16, torch.bfloat16)


@pytest.fixture
def received(monkeypatch):
    """``[(op name, dtypes of its tensor arguments)]`` of every op call."""
    seen = []
    call = core.KernelOp.__call__

    def record(self, *args, **kwargs):
        seen.append((self.name, [a.dtype for a in args
                                 if isinstance(a, torch.Tensor)]))
        return call(self, *args, **kwargs)
    monkeypatch.setattr(core.KernelOp, '__call__', record)
    return seen


def _spikes(shape, dtype, seed):
    """Spikes with positive, zero, negative and (float) NaN entries."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.array([-2, -1, 0, 0, 0, 1, 2], np.float32), shape)
    if dtype == torch.uint8:
        vals = np.abs(vals)
    x = torch.from_numpy(vals).to(dtype)
    if dtype.is_floating_point:
        x.view(-1)[::11] = float('nan')
    return x


def _gate(x, nonzero=False):
    if x.dtype == torch.bool:
        return x
    return x != 0 if nonzero else x > 0


def _jax(x):
    """A port tensor as a JAX array of the same dtype and values."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _torch(y):
    """A JAX result as a port tensor of the same dtype and values."""
    y = np.asarray(y)
    if y.dtype == jnp.bfloat16:
        return torch.from_numpy(y.astype(F32)).to(torch.bfloat16)
    return torch.from_numpy(y.copy())


N, M, B = 40, 30, 5
JITC = (F32(0.6), F32(0.06), 0.2)        # float32 weights in both packages


def _structures():
    rng = np.random.default_rng(71)
    A = np.where(rng.random((N, M)) < 0.3, rng.normal(size=(N, M)), 0).astype(
        F32)
    csr = bt.CSR.fromdense(torch.from_numpy(A))
    idx = torch.from_numpy(rng.integers(0, M, (N, 6)).astype(np.int32))
    w_ell = torch.from_numpy(rng.normal(size=(N, 6)).astype(F32))
    W = torch.from_numpy(rng.normal(size=(N, M)).astype(F32))
    trace = torch.from_numpy(rng.random(M).astype(F32))
    return dict(csr=csr, idx=idx, w_ell=w_ell, W=W, trace=trace)


def _entries(st, w_dtype=torch.float32, m=bt, conv=lambda x: x):
    """``name -> (fn(spikes), spike shape, ops it calls, nonzero gate)``:
    each public entry of an event kernel, with weights in *w_dtype*, in
    the package *m* (``bt`` or ``be``) with its tensors through *conv*
    (:func:`_jax` for ``be``)."""
    csr = st['csr']
    data, ind, ptr = (conv(t) for t in (csr.data.to(w_dtype), csr.indices,
                                        csr.indptr))
    W, w_ell = conv(st['W'].to(w_dtype)), conv(st['w_ell'].to(w_dtype))
    idx, trace = conv(st['idx']), conv(st['trace'])
    kw_csr = dict(shape=csr.shape)
    row_count = (bt.binary_2d_csr_row_count_p_call if m is bt
                 else be.events.binary_2d_csr_row_count_p_call)
    return {
        'binary_fcnmv T (K5)': (lambda s: m.binary_fcnmv(
            w_ell, idx, conv(s), shape=(N, M), transpose=True), (N,),
            {'fcn_event_scatter'}, False),
        'binary_fcnmv (K6)': (lambda s: m.binary_fcnmv(
            w_ell, idx, conv(s), shape=(N, M)), (M,), {'fcn_event_gather'},
            False),
        'binary_csrmv (K7)': (lambda s: m.binary_csrmv(
            data, ind, ptr, conv(s), **kw_csr), (M,), {'csr_gather_mv'},
            False),
        'binary_csrmv T (K8)': (lambda s: m.binary_csrmv(
            data, ind, ptr, conv(s), transpose=True, **kw_csr), (N,),
            {'csr_scatter_mv'}, False),
        'binary_csrmm (K10)': (lambda s: m.binary_csrmm(
            data, ind, ptr, conv(s), **kw_csr), (M, B), {'csr_gather_mm'},
            False),
        'binary_jitnmv (K12)': (lambda s: m.binary_jitnmv(
            *JITC, conv(s), 5, shape=(N, M)), (M,), {'jitc_walk_mv'}, False),
        'binary_jitnmm (K13)': (lambda s: m.binary_jitnmm(
            *JITC, conv(s), 5, shape=(N, M)), (M, B), {'jitc_walk_mm4'},
            False),
        'binary_densemv (K15)': (lambda s: m.binary_densemv(
            W, conv(s), transpose=True), (N,), {'dense_event_mv'}, False),
        'binary_densemm (K16)': (lambda s: m.binary_densemm(
            W, conv(s), transpose=False), (M, B), {'dense_event_mm'}, False),
        'update_dense_on_binary_pre (K17)': (
            lambda s: m.update_dense_on_binary_pre(
                W, conv(s), trace, -1.0, 1.0), (N,), {'dense_stdp_pre'},
            True),
        'binary_2d_csr_row_count (K18)': (
            lambda s: row_count(conv(s))[0], (N, B), {'event_row_count'},
            True),
    }


ENTRIES = sorted(_entries(_structures()))
WEIGHTED = [e for e in ENTRIES if 'jitn' not in e and 'row_count' not in e]
EXACT = ('dense_on_binary', 'row_count')
# the JAX package's XLA csrmm kernel, which it runs on the CPU, adds the
# half products in the weights' dtype (brainevent_tpu/csr/binary.py:270-
# 277); its Pallas route, like the port, rounds once from float32. Its
# result is then within the half summation bound eps * sum|w| gate
HALF_SUMS = ('binary_csrmm (K10)',)


def _abs_structures(st):
    """*st* with every weight replaced by its magnitude: an entry over
    them gives ``sum|w| gate`` per output, the scale of its bound."""
    out = {k: (v.abs() if k in ('W', 'w_ell') else v) for k, v in st.items()}
    csr = st['csr']
    out['csr'] = bt.CSR((csr.data.abs(), csr.indices, csr.indptr),
                        shape=csr.shape)
    return out


def _jax_result(entry, st, w_dtype, s):
    """The JAX package's result of *entry* on the same inputs, as a
    tensor."""
    with jax.enable_x64(True):
        fn = _entries(st, w_dtype, be, _jax)[entry][0]
        return _torch(fn(s))


def _assert_matches_jax(entry, st, w_dtype, s, got, rel):
    """*got* against the JAX package: the same dtype, and within ``rel *
    sum|w| gate`` per output (plus 1 ulp of a half result, and
    :data:`HALF_SUMS`' summation bound), exact for the entries whose result
    is one rounding or an integer."""
    want = _jax_result(entry, st, w_dtype, s)
    assert got.dtype == want.dtype, (entry, got.dtype, want.dtype)
    assert got.shape == want.shape, entry
    if any(k in entry for k in EXACT):
        assert torch.equal(got, want), entry
        return
    scale = _entries(_abs_structures(st))[entry][0](s).double()
    got, want = got.double(), want.double()
    tol = rel * scale
    if w_dtype in HALF:
        eps = torch.finfo(w_dtype).eps
        tol = tol + eps * torch.maximum(got.abs(), want.abs())
        if entry in HALF_SUMS:
            tol = tol + eps * scale
    assert bool(((got - want).abs() <= tol).all()), (
        entry, float((got - want).abs().max()))


@pytest.mark.parametrize('dtype', SPIKE_DTYPES, ids=str)
@pytest.mark.parametrize('entry', ENTRIES)
def test_spikes_of_any_dtype_reach_the_ops_as_their_gate(received, entry,
                                                         dtype):
    st = _structures()
    fn, shape, ops, nonzero = _entries(st)[entry]
    s = _spikes(shape, dtype, seed=len(entry))
    want = fn(_gate(s, nonzero))
    received.clear()
    got = fn(s)
    assert {name for name, _ in received} == ops
    for _, dtypes in received:
        assert set(dtypes) <= {torch.bool, torch.float32, torch.int32}, dtypes
    assert got.dtype == want.dtype and torch.equal(got, want)
    # the JAX package gates the same spikes to the same result
    _assert_matches_jax(entry, st, torch.float32, s, got, 1e-5)


@pytest.mark.parametrize('dtype', HALF, ids=str)
@pytest.mark.parametrize('entry', WEIGHTED)
def test_half_weights_compute_in_float32(received, entry, dtype):
    st = _structures()
    fn, shape, ops, nonzero = _entries(st, dtype)[entry]
    s = _spikes(shape, torch.int8, seed=3)
    received.clear()
    got = fn(s)
    assert {name for name, _ in received} == ops
    for _, dtypes in received:
        assert torch.float32 in dtypes and not set(dtypes) & set(HALF)
    assert got.dtype == dtype
    # the float32 kernel's result on the widened weights, rounded once
    assert torch.equal(got, _half_reference(entry, st, dtype, s))
    _assert_matches_jax(entry, st, dtype, s, got, 1e-5)


def _half_reference(entry, st, dtype, s):
    """The entry computed on weights rounded to *dtype* and widened back
    to float32, then rounded to *dtype*."""
    rounded = {k: (v.to(dtype).to(torch.float32) if isinstance(
        v, torch.Tensor) and v.is_floating_point() and k != 'trace' else v)
        for k, v in st.items() if k != 'csr'}
    csr = st['csr']
    rounded['csr'] = bt.CSR((csr.data.to(dtype).to(torch.float32),
                             csr.indices, csr.indptr), shape=csr.shape)
    if 'dense_on_binary' in entry:
        rounded['trace'] = st['trace'].to(dtype).to(torch.float32)
    fn = _entries(rounded, torch.float32)[entry][0]
    return fn(s).to(dtype)


@pytest.mark.parametrize('entry', WEIGHTED)
def test_float64_weights_take_the_twin_in_float64(received, entry):
    # on the CPU the op runs its twin, which computes in float64; on the
    # card the entry raises instead (tests/test_torch_cuda.py)
    st = _structures()
    fn, shape, ops, nonzero = _entries(st, torch.float64)[entry]
    s = _spikes(shape, torch.float32, seed=4)
    received.clear()
    got = fn(s)
    assert got.dtype == torch.float64
    assert {name for name, _ in received} == ops
    for _, dtypes in received:
        assert torch.float64 in dtypes, dtypes
    _assert_matches_jax(entry, st, torch.float64, s, got, 1e-12)


def test_float64_stdp_keeps_every_bit_of_w():
    # W + 0 * trace leaves W as it is: a float64 W is never rounded
    W = torch.full((3, 4), 1.0 + 2.0 ** -40, dtype=torch.float64)
    out = bt.update_dense_on_binary_pre(W, torch.zeros(3, dtype=torch.int8),
                                        torch.ones(4, dtype=torch.float64))
    assert out.dtype == torch.float64 and torch.equal(out, W)
    csr = bt.CSR.fromdense(W)
    new = csr.update_on_pre(torch.zeros(3, dtype=torch.bool),
                            torch.ones(4, dtype=torch.float64))
    assert new.data.dtype == torch.float64 and torch.equal(new.data, csr.data)


@pytest.mark.parametrize('dtype', HALF + (torch.float64,), ids=str)
def test_float_operands_of_csr_and_jitc(received, dtype):
    """A CSR or JITC float product takes its operand in the weights'
    dtype, float32 here, as the JAX package casts it to its output's; each
    result is held against the JAX package."""
    rng = np.random.default_rng(72)
    csr = _structures()['csr']
    v = torch.from_numpy(rng.normal(size=M).astype(F32))
    cases = (
        ('csr_gather_mv', lambda m, c, x: m.csrmv(
            c(csr.data), c(csr.indices), c(csr.indptr), c(x),
            shape=csr.shape)),
        ('jitc_walk_mv', lambda m, c, x: m.jitnmv(*JITC, c(x), 5,
                                                  shape=(N, M))))
    for name, fn in cases:
        received.clear()
        got = fn(bt, lambda t: t, v.to(dtype))
        seen = [d for n, d in received if n == name]
        want = fn(bt, lambda t: t, v.to(dtype).to(torch.float32))
        assert seen[0][-1] == torch.float32
        assert got.dtype == torch.float32 and torch.equal(got, want)
        with jax.enable_x64(True):
            jgot = _torch(fn(be, _jax, v.to(dtype)))
        scale = fn(bt, lambda t: t, v.abs().double()).abs()
        assert jgot.dtype == got.dtype, (name, jgot.dtype, got.dtype)
        assert bool(((got.double() - jgot.double()).abs()
                     <= 1e-5 * scale).all()), name
