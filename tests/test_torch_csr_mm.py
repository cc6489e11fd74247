# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The mat-mat half of brainevent_torch (twin of K10 ``csr_gather_mm``)
against brainevent_tpu on the CPU.

``build_mm_plan`` is the JAX plan bitwise. ``gather_matmat`` is held
against the JAX kernel (Pallas in interpret mode) and ``csrmm`` /
``binary_csrmm`` against the JAX products in both directions: the sums
run in another order, hence rtol 1e-5, atol 1e-5. ``plan_matmat_vjp``'s
gradient, with an operand wider than the JAX kernel's VMEM guard allows
(fault C3 of the JAX package), is held against a dense oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.ops import mxu_gather as tg
from brainevent_tpu.csr import binary as jb
from brainevent_tpu.csr import float as jf
from brainevent_tpu.ops import mxu_gather as jg

from _torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


def _coo(seed, M, N, nse):
    rng = np.random.default_rng(seed)
    return rng.integers(0, M, nse), rng.integers(0, N, nse), rng


def _dense(rows, cols, w, M, N):
    d = np.zeros((M, N), np.float64)
    np.add.at(d, (rows, cols), w)
    return d


@pytest.mark.parametrize('M,N,nse', [(256, 256, 900), (500, 700, 3000),
                                     (129, 1000, 2000), (40, 50, 0)])
def test_build_mm_plan_bitwise(M, N, nse):
    rows, cols, _ = _coo(1, M, N, nse)
    jp, tp = jg.build_mm_plan(rows, cols, (M, N)), tg.build_mm_plan(
        rows, cols, (M, N))
    for field in ('meta', 'b0', 'rb', 'perm'):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)))
    assert tg.plan_aux(tp) == jg.plan_aux(jp)
    assert (tp.chunk, tp.row_block, tp.win_blocks) == (256, 128, 1)
    # the row index lists each valid slot once, with its decoded column
    perm = tp.perm.numpy().reshape(-1)
    slots = tp.row_slots.numpy()
    assert sorted(slots) == list(np.flatnonzero(perm >= 0))
    np.testing.assert_array_equal(tp.row_cols.numpy(), cols[perm[slots]])


@pytest.mark.parametrize('M,N,B,nse', [(256, 256, 16, 900),
                                       (500, 700, 36, 3000)])
def test_gather_matmat_matches_jax(M, N, B, nse):
    rows, cols, rng = _coo(2, M, N, nse)
    w = rng.normal(size=nse).astype(np.float32)
    X = rng.normal(size=(N, B)).astype(np.float32)
    jp, tp = jg.build_mm_plan(rows, cols, (M, N)), tg.build_mm_plan(
        rows, cols, (M, N))
    want = jg.gather_matmat(jp, jp.sort_data(jnp.asarray(w)), jnp.asarray(X),
                            force_xla=False)
    ws = tp.sort_data(torch.from_numpy(w))
    got = bt.gather_matmat(tp, ws, torch.from_numpy(X), passes=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    oracle = tg.gather_matmat_xla(tp, ws, torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _dense(rows, cols, w, M, N) @ X,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('B', [8, 1000], ids=['narrow', 'wide'])
def test_plan_matmat_vjp_grad_matches_dense(B):
    M, N, nse = 90, 70, 800
    rows, cols, rng = _coo(3, M, N, nse)
    w = rng.normal(size=nse).astype(np.float32)
    X = rng.normal(size=(N, B)).astype(np.float32)
    ct = rng.normal(size=(M, B)).astype(np.float32)
    pf = tg.build_mm_plan(rows, cols, (M, N))
    pb = tg.build_mm_plan(cols, rows, (N, M))
    wt = torch.from_numpy(w)
    Xt = torch.from_numpy(X).requires_grad_(True)
    Y = bt.plan_matmat_vjp(pf, pb, pf.sort_data(wt), pb.sort_data(wt), Xt,
                           passes=3)
    (g,) = torch.autograd.grad(Y, Xt, torch.from_numpy(ct))
    D = _dense(rows, cols, w, M, N)
    np.testing.assert_allclose(Y.detach().numpy(), D @ X, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(g.numpy(), D.T @ ct, rtol=RTOL, atol=ATOL)


def _csr_case(seed, m, k, homo):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, m)
    counts[[1, -1]] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, k, indptr[-1]).astype(np.int32)
    w = (np.array([0.25], np.float32) if homo
         else rng.normal(size=indices.size).astype(np.float32))
    return w, indices, indptr, rng


@pytest.mark.parametrize('kind', ['float', 'bool', 'gate'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
def test_csrmm_matches_jax(kind, homo, transpose):
    m, k, B = 110, 90, 12
    w, indices, indptr, rng = _csr_case(4, m, k, homo)
    n_in = m if transpose else k
    if kind == 'float':
        X = rng.normal(size=(n_in, B)).astype(np.float32)
    elif kind == 'bool':
        X = rng.random((n_in, B)) < 0.2
    else:
        X = np.where(rng.random((n_in, B)) < 0.2, 1.0,
                     -rng.random((n_in, B))).astype(np.float32)
    jfn, tfn = ((jf.csrmm, bt.csrmm) if kind == 'float'
                else (jb.binary_csrmm, bt.binary_csrmm))
    want = jfn(*map(jnp.asarray, (w, indices, indptr, X)), shape=(m, k),
               transpose=transpose)
    got = tfn(*(torch.from_numpy(np.asarray(a))
                for a in (w, indices, indptr, X)), shape=(m, k),
              transpose=transpose)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
def test_binary_csrmm_indexed_matches_jax(transpose):
    m, k, B = 80, 100, 6
    w, indices, indptr, rng = _csr_case(5, m, k, False)
    perm = rng.permutation(indices.size).astype(np.int32)
    X = rng.random((m if transpose else k, B)) < 0.3
    (want,) = jb.binary_csrmm_indexed_p_call(
        *map(jnp.asarray, (w, indices, indptr, perm, X)), shape=(m, k),
        transpose=transpose)
    got = bt.binary_csrmm_indexed(
        *(torch.from_numpy(np.asarray(a))
          for a in (w, indices, indptr, perm, X)), shape=(m, k),
        transpose=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
def test_csrmm_grads_match_jax(transpose):
    m, k, B = 70, 60, 5
    w, indices, indptr, rng = _csr_case(6, m, k, False)
    X = rng.normal(size=(m if transpose else k, B)).astype(np.float32)
    ct = rng.normal(size=(k if transpose else m, B)).astype(np.float32)

    def jloss(w_, X_):
        y = jf.csrmm(w_, jnp.asarray(indices), jnp.asarray(indptr), X_,
                     shape=(m, k), transpose=transpose)
        return jnp.sum(y * jnp.asarray(ct))

    jw, jX = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(X))
    tw = torch.from_numpy(w).requires_grad_(True)
    tX = torch.from_numpy(X).requires_grad_(True)
    y = bt.csrmm(tw, torch.from_numpy(indices), torch.from_numpy(indptr), tX,
                 shape=(m, k), transpose=transpose)
    gw, gX = torch.autograd.grad(y, (tw, tX), torch.from_numpy(ct))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gX.numpy(), np.asarray(jX), rtol=RTOL,
                               atol=ATOL)


# -- K10's stored-order plain sum (csr_gather_mm_ordered) ---------------------------

def _ordered_numpy(indptr, indices, perm, w, X, binary):
    """The stored-order sum in numpy float32: one entry at a time, the
    product (or the gated weight) rounded, then the add rounded."""
    n_x, B = X.shape
    homo = w.shape == (1,)
    x = ((X if X.dtype == bool else X > 0) if binary else X).astype(w.dtype)
    Y = np.zeros((indptr.size - 1, B), w.dtype)
    for r in range(indptr.size - 1):
        acc = np.zeros(B, w.dtype)
        for j in range(indptr[r], indptr[r + 1]):
            c = indices[j]
            if not 0 <= c < n_x:
                continue
            if homo and binary:
                acc = acc + x[c]
                continue
            wt = w[0] if homo else w[j if perm is None else perm[j]]
            acc = acc + (np.where(x[c] != 0, wt, w.dtype.type(0)) if binary
                         else wt * x[c])
        Y[r] = acc * w[0] if homo and binary else acc
    return Y


def _mm_operand(rng, n, B, kind):
    if kind == 'float':
        return rng.normal(size=(n, B)).astype(np.float32)
    if kind == 'bool':
        return rng.random((n, B)) < 0.3
    return np.where(rng.random((n, B)) < 0.3, 1.0,
                    -rng.random((n, B))).astype(np.float32)


@pytest.mark.parametrize('kind', ['float', 'bool', 'gate'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
@pytest.mark.parametrize('B', [1, 3, 16, 17, 256])
def test_csr_gather_mm_ordered_matches_jax_and_numpy(B, transpose, homo,
                                                     kind):
    """Bitwise the numpy stored-order loop; within 1e-5 * sum|w x| of the
    JAX products. NT runs over the CSR arrays, T over the CSC mirror with
    its slot permutation; the matrix has empty rows and columns."""
    m, k = 37, 29
    w, indices, indptr, rng = _csr_case(7 + B, m, k, homo)
    X = _mm_operand(rng, m if transpose else k, B, kind)
    binary = kind != 'float'
    ptr, idx, perm = (torch.from_numpy(indptr), torch.from_numpy(indices),
                      None)
    if transpose:
        ptr, idx, perm = bt._misc.csr_to_csc_index(ptr, idx, shape=(m, k))
    perm_k = None if homo else perm
    got = tg.csr_gather_mm_ordered(ptr, idx, perm_k, torch.from_numpy(w),
                                   torch.from_numpy(X), binary)
    want = _ordered_numpy(ptr.numpy(), idx.numpy(),
                          None if perm_k is None else perm_k.numpy(), w, X,
                          binary)
    np.testing.assert_array_equal(got.numpy(), want)
    jfn = jb.binary_csrmm if binary else jf.csrmm
    ref = np.asarray(jfn(*map(jnp.asarray, (w, indices, indptr, X)),
                         shape=(m, k), transpose=transpose))
    xa = (np.abs(X) if kind == 'float' else
          (X if X.dtype == bool else X > 0).astype(np.float32))
    bound = np.abs(_dense(np.repeat(np.arange(m), np.diff(indptr)), indices,
                          np.broadcast_to(w, indices.shape), m, k))
    bound = (bound.T if transpose else bound) @ xa
    assert got.shape == ref.shape
    assert (np.abs(got.numpy() - ref) <= 1e-5 * bound + 1e-30).all()


@pytest.mark.parametrize('kind', ['float', 'bool', 'gate'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
def test_csr_gather_mm_ordered_drops_out_of_range_columns(homo, kind):
    """Column ids outside [0, n_x) add nothing: bitwise the numpy loop,
    within 1e-5 * sum|w x| of the twin, and a row whose every column is
    out of range is 0."""
    m, k, B = 30, 20, 5
    w, indices, indptr, rng = _csr_case(8, m, k, homo)
    indices = indices.copy()
    indices[::5] = k + 3
    indices[1::7] = -1
    indices[indptr[2]:indptr[3]] = k
    X = _mm_operand(rng, k, B, kind)
    binary = kind != 'float'
    args = (torch.from_numpy(indptr), torch.from_numpy(indices), None,
            torch.from_numpy(w), torch.from_numpy(X), binary)
    got = tg.csr_gather_mm_ordered(*args)
    np.testing.assert_array_equal(
        got.numpy(), _ordered_numpy(indptr, indices, None, w, X, binary))
    assert not got[2].any()
    twin = tg.csr_gather_mm_twin(*args)
    bound = tg.csr_gather_mm_twin(*args[:3], args[3].abs(),
                                  args[4].abs() if kind == 'float'
                                  else args[4], binary)
    assert bool(((got - twin).abs() <= 1e-5 * bound + 1e-30).all())


def test_csr_gather_mm_ordered_float64():
    """float64 weights and operand sum in float64, bitwise the numpy
    loop."""
    m, k, B = 25, 31, 6
    w, indices, indptr, rng = _csr_case(9, m, k, False)
    w = w.astype(np.float64)
    X = rng.normal(size=(k, B))
    got = tg.csr_gather_mm_ordered(
        torch.from_numpy(indptr), torch.from_numpy(indices), None,
        torch.from_numpy(w), torch.from_numpy(X), False)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(
        got.numpy(), _ordered_numpy(indptr, indices, None, w, X, False))
