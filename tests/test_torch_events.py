# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The port's event representations and encoders against the JAX package
on the CPU: ``bitpack`` and ``BitPackedBinary``, the eight encoders with
the CSR/CSC helpers (bitwise: the same integers in the same places, zero
tails included), the row count also against the interpreted Pallas
kernel, ``CompactBinary`` and its products, and ``CompactBinary``
operands of the CSR classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
import brainevent_tpu as be
from brainevent_torch import events as te
from brainevent_tpu import events as je

from _torch_one_thread import one_torch_thread  # noqa: F401


def _spikes(shape, rate, kind, seed):
    """bool; or float with negative and NaN events (the encoders gate at
    ``!= 0``) and exact zeros elsewhere."""
    rng = np.random.default_rng(seed)
    on = rng.random(shape) < rate
    if kind == 'bool':
        return on
    x = np.where(on, rng.choice([1.0, -0.5, 2.0], shape), 0.0).astype(
        np.float32)
    x[on & (rng.random(shape) < 0.1)] = np.nan
    return x


def _eq(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


# -- bitpack ----------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('shape,axis', [((70,), 0), ((5, 70), 1), ((70, 5), 0),
                                        ((3, 33, 4), 1), ((3, 33, 4), -1)],
                         ids=str)
def test_bitpack_matches_jax(shape, axis, kind):
    x = _spikes(shape, 0.4, kind, 1)
    _eq(bt.bitpack(torch.from_numpy(x), axis), be.bitpack(jnp.asarray(x), axis))


def test_bitpacked_binary_products_match_jax():
    rng = np.random.default_rng(2)
    s, S = rng.random(16) < 0.4, rng.random((3, 16)) < 0.4
    w = rng.normal(size=(16, 8)).astype(np.float32)
    for x in (s, S):
        jp, tp = be.BitPackedBinary(jnp.asarray(x)), bt.BitPackedBinary(
            torch.from_numpy(x))
        assert tp.shape == jp.shape and tp.ndim == jp.ndim
        _eq(tp.packed, jp.packed)
        np.testing.assert_allclose((tp @ torch.from_numpy(w)).numpy(),
                                   np.asarray(jp @ jnp.asarray(w)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tp.dot(torch.from_numpy(w)).numpy(),
                                   x.astype(np.float32) @ w, rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        (torch.from_numpy(w.T) @ bt.BitPackedBinary(torch.from_numpy(
            s))).numpy(),
        np.asarray(jnp.asarray(w.T) @ be.BitPackedBinary(jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(bt.MathError):
        bt.BitPackedBinary(torch.from_numpy(s)) @ torch.ones(5, 2)
    ba = bt.BinaryArray(torch.ones(40, dtype=torch.bool))
    bp = ba.bitpack()
    assert isinstance(bp, bt.BitPackedBinary) and bp.packed[0].shape == (2,)
    acc = bt.BinaryArray(torch.from_numpy(s))
    acc @= torch.from_numpy(w)
    np.testing.assert_allclose(acc.numpy(), s.astype(np.float32) @ w,
                               rtol=1e-6, atol=1e-6)


# -- the encoders ------------------------------------------------------------------

ENCODERS = ('binary_2d_compact_only_p_call', 'binary_2d_array_index_p_call',
            'binary_2d_pair_stream_encode_p_call',
            'binary_2d_row_sparse_encode_p_call',
            'binary_2d_csr_row_count_p_call', 'binary_2d_csc_encode_p_call',
            'binary_2d_csr_encode_p_call', 'binary_2d_csc_from_array')
SHAPES = {'16x512@5%': ((16, 512), 0.05), '16x100@30%': ((16, 100), 0.3),
          'quiet': ((6, 8), 0.0), 'full': ((6, 8), 1.0)}


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('case', sorted(SHAPES))
@pytest.mark.parametrize('fn', ENCODERS)
def test_2d_encoders_bitwise(fn, case, kind):
    shape, rate = SHAPES[case]
    x = _spikes(shape, rate, kind, 3)
    _eq(getattr(te, fn)(torch.from_numpy(x)), getattr(je, fn)(jnp.asarray(x)))


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('n,rate', [(512, 0.05), (100, 0.3), (16, 0.0),
                                    (16, 1.0)])
def test_1d_array_index_bitwise(n, rate, kind):
    x = _spikes((n,), rate, kind, 4)
    _eq(bt.binary_1d_array_index_p_call(torch.from_numpy(x)),
        je.binary_1d_array_index_p_call(jnp.asarray(x)))


def test_csr_fill_with_given_indptr_bitwise():
    x = _spikes((16, 100), 0.3, 'float', 5)
    counts = (x != 0).sum(1)
    for indptr in (np.concatenate([[0], np.cumsum(counts)]),
                   np.concatenate([[0], np.cumsum(counts + 2)])):
        indptr = indptr.astype(np.int32)
        _eq(bt.binary_2d_csr_fill_p_call(torch.from_numpy(x),
                                         torch.from_numpy(indptr)),
            je.binary_2d_csr_fill_p_call(jnp.asarray(x), jnp.asarray(indptr)))
    with pytest.raises(ValueError, match='indptr length'):
        bt.binary_2d_csr_fill_p_call(torch.from_numpy(x), torch.zeros(3))


@pytest.mark.parametrize('shape', [(16, 512), (16, 100), (1030, 7)], ids=str)
def test_row_count_matches_jax_and_interpreted_pallas(shape):
    """The row count against the JAX kernels: the interpreted Pallas one
    once, at the encoders' (16, 512), and ``jax_raw`` at the others."""
    x = _spikes(shape, 0.05, 'float', 6)
    backend = 'pallas' if shape == (16, 512) else 'jax_raw'
    (want,) = je.binary_2d_csr_row_count_p_call(jnp.asarray(x),
                                                backend=backend)
    (got,) = bt.binary_2d_csr_row_count_p_call(torch.from_numpy(x))
    _eq(got, want)
    assert got.tolist() == (x != 0).sum(1).tolist()


def test_row_sparse_row_size():
    x = _spikes((8, 20), 0.15, 'bool', 7)
    for row_size in (None, 10, 20):
        _eq(bt.binary_2d_row_sparse_encode_p_call(torch.from_numpy(x),
                                                  row_size=row_size),
            je.binary_2d_row_sparse_encode_p_call(jnp.asarray(x),
                                                  row_size=row_size))
    y = np.zeros((4, 12), bool)
    y[2, :7] = True                           # row NNZ 7 > row_size 4
    with pytest.raises(ValueError, match='too small'):
        bt.binary_2d_row_sparse_encode_p_call(torch.from_numpy(y), row_size=4)
    with pytest.raises(ValueError, match='positive'):
        bt.binary_2d_row_sparse_encode_p_call(torch.from_numpy(y), row_size=0)
    with pytest.raises(ValueError, match='<= n_batch'):
        bt.binary_2d_row_sparse_encode_p_call(torch.from_numpy(y),
                                              row_size=13)


def test_encoders_refuse_other_ranks():
    for fn in ENCODERS:
        with pytest.raises(ValueError, match='2D'):
            getattr(te, fn)(torch.zeros(4))
    with pytest.raises(ValueError, match='1D'):
        bt.binary_1d_array_index_p_call(torch.zeros(2, 2))


# -- CompactBinary ---------------------------------------------------------------

@pytest.mark.parametrize('shape', [(70,), (16, 40)], ids=str)
def test_compact_binary_constructors_match_jax(shape):
    x = _spikes(shape, 0.2, 'float', 8)
    for ctor in ('from_array', 'from_array_light'):
        jc = getattr(be.CompactBinary, ctor)(jnp.asarray(x))
        tc = getattr(bt.CompactBinary, ctor)(torch.from_numpy(x))
        if jc.packed is None:
            assert tc.packed is None
        else:
            _eq(tc.packed, jc.packed)
        _eq((tc.active_ids, tc.n_active), (jc.active_ids, jc.n_active))
        assert (tc.shape, tc.ndim, tc.size, tc.n_orig, tc.batch_size,
                tc.bit_width) == (jc.shape, jc.ndim, jc.size, jc.n_orig,
                                  jc.batch_size, jc.bit_width)
        assert tc.dtype == torch.float32
        assert tc.to_dense() is tc.value
    tv = bt.CompactBinary.compacy_only_vector(torch.from_numpy(x))
    jv = be.CompactBinary.compacy_only_vector(jnp.asarray(x))
    _eq((tv.active_ids, tv.n_active), (jv.active_ids, jv.n_active))
    assert bt.CompactBinary.compact_only_vector is not None
    tp = bt.CompactBinary.from_packed(None, tv.active_ids, tv.n_active,
                                      tv.value)
    assert tp.n_orig == tv.value.shape[0]
    with pytest.raises(ValueError):
        bt.CompactBinary.from_array(torch.zeros(2, 2, 2))


def test_compact_binary_products_match_jax():
    rng = np.random.default_rng(9)
    w = rng.normal(size=(40, 30)).astype(np.float32)
    s, S = _spikes((40,), 0.3, 'bool', 10), _spikes((5, 40), 0.3, 'bool', 11)
    u = _spikes((30,), 0.3, 'bool', 12)
    J, T = be.Dense(jnp.asarray(w)), bt.Dense(torch.from_numpy(w))
    for x in (s, S):
        jc = be.CompactBinary.from_array(jnp.asarray(x))
        tc = bt.CompactBinary.from_array(torch.from_numpy(x))
        for want, got in ((jc @ jnp.asarray(w), tc @ torch.from_numpy(w)),
                          (jc @ J, tc @ T)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    jc = be.CompactBinary.from_array(jnp.asarray(u))
    tc = bt.CompactBinary.from_array(torch.from_numpy(u))
    for want, got in ((jnp.asarray(w) @ jc, torch.from_numpy(w) @ tc),
                      (J @ jc, T @ tc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_csr_classes_take_compact_binary():
    """``CSR``/``CSC`` products and STDP take a ``CompactBinary`` through
    its ``value``, as the JAX classes do."""
    rng = np.random.default_rng(13)
    dense = ((rng.random((50, 40)) < 0.2) * rng.random((50, 40))).astype(
        np.float32)
    for cls_j, cls_t in ((be.CSR, bt.CSR), (be.CSC, bt.CSC)):
        J, T = cls_j.fromdense(jnp.asarray(dense)), cls_t.fromdense(
            torch.from_numpy(dense))
        for x in (_spikes((40,), 0.3, 'float', 14),
                  _spikes((40, 3), 0.3, 'bool', 15)):
            x = np.nan_to_num(x)
            want = J @ be.CompactBinary.from_array(jnp.asarray(x))
            got = T @ bt.CompactBinary.from_array(torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
            want = J @ be.BinaryArray(jnp.asarray(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        for x in (_spikes((50,), 0.3, 'bool', 16),
                  _spikes((4, 50), 0.3, 'bool', 17)):
            want = be.CompactBinary.from_array(jnp.asarray(x)) @ J
            got = bt.CompactBinary.from_array(torch.from_numpy(x)) @ T
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        pre, post = _spikes((50,), 0.3, 'bool', 18), _spikes((40,), 0.3,
                                                              'bool', 19)
        t_pre, t_post = rng.random(50).astype(np.float32), rng.random(
            40).astype(np.float32)
        # the JAX classes' STDP takes the raw spikes of a CompactBinary
        J2 = J.update_on_pre(jnp.asarray(pre), jnp.asarray(t_post), 0.0, 1.0)
        J2 = J2.update_on_post(jnp.asarray(t_pre), jnp.asarray(post), 0.0,
                               1.0)
        T2 = T.update_on_pre(bt.CompactBinary.from_array(torch.from_numpy(
            pre)), torch.from_numpy(t_post), 0.0, 1.0)
        T2 = T2.update_on_post(torch.from_numpy(t_pre),
                               bt.CompactBinary.from_array_light(
                                   torch.from_numpy(post)), 0.0, 1.0)
        np.testing.assert_array_equal(T2.data.numpy(), np.asarray(J2.data))
