# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The pair product (twin of K9 ``pair_gather``) and the CSR STDP updates
of brainevent_torch against brainevent_tpu on the CPU.

``pair_gather_product`` is one gather per side and one multiply, so the
port equals the JAX kernel (Pallas in interpret mode) bitwise. The STDP
updates add a product whose gate is 0 or 1, so the product is exact and
one rounding remains: the port equals both JAX routes bitwise, the
``pallas`` route (product materialised, then added) and ``jax_raw``
(``weight + gate[rows] * trace[indices]`` in one expression).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.ops import pair_gather as tpg
from brainevent_tpu.csr import plasticity as jp
from brainevent_tpu.ops.pair_gather import pair_gather_product as jpair

from _torch_one_thread import one_torch_thread  # noqa: F401


def _ids(rng, n, nse, sentinel):
    ids = rng.integers(0, n, nse).astype(np.int32)
    if sentinel:
        ids[::7] = -1
    return ids


@pytest.mark.parametrize('sides', ['both', 'rows', 'cols'])
@pytest.mark.parametrize('sentinel', [False, True], ids=['ids', 'sentinel'])
def test_pair_gather_product_bitwise(sides, sentinel):
    rng = np.random.default_rng(7)
    m, k, nse = 300, 500, 2049
    rows, cols = _ids(rng, m, nse, sentinel), _ids(rng, k, nse, sentinel)
    s = rng.normal(size=m).astype(np.float32)
    x = rng.normal(size=k).astype(np.float32)
    args = [rows, cols, s, x]
    if sides == 'rows':
        args[1] = args[3] = None
    elif sides == 'cols':
        args[0] = args[2] = None
    want = jpair(*(None if a is None else jnp.asarray(a) for a in args))
    got = bt.pair_gather_product(*(None if a is None else torch.from_numpy(a)
                                   for a in args), s_passes=1, x_passes=2)
    assert want is not None and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if sentinel and sides != 'cols':
        assert (got[::7] == 0).all()


def test_pair_gather_product_checks_and_empty():
    with pytest.raises(ValueError):
        bt.pair_gather_product(None, None, None, None)
    with pytest.raises(ValueError):
        bt.pair_gather_product(torch.zeros(3, dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32),
                               torch.ones(2), torch.ones(2))
    out = bt.pair_gather_product(torch.zeros(0, dtype=torch.int32), None,
                                 torch.ones(8), None)
    assert out.shape == (0,)
    # ids past the end of an operand give 0, as the TPU kernel's padding
    out = tpg.pair_gather_twin(torch.tensor([0, 2, 9], dtype=torch.int32),
                               None, torch.tensor([1.5, 2.5]), None)
    assert out.tolist() == [1.5, 0.0, 0.0]


def _stdp_case(seed, homo):
    rng = np.random.default_rng(seed)
    m, k = 140, 110
    counts = rng.integers(0, 15, m)
    counts[[2, -1]] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, k, indptr[-1]).astype(np.int32)
    w = (np.array([0.5], np.float32) if homo
         else rng.random(indices.size).astype(np.float32))
    pre_spike = rng.random(m) < 0.2
    post_spike = (rng.random(k) < 0.2).astype(np.float32)
    pre_trace = rng.random(m).astype(np.float32)
    post_trace = (rng.random(k) - 0.3).astype(np.float32)
    return (m, k), w, indices, indptr, pre_spike, post_spike, pre_trace, \
        post_trace


@pytest.mark.parametrize('backend', ['pallas', 'jax_raw'])
@pytest.mark.parametrize('clip', [None, (0.1, 0.9)], ids=['free', 'clip'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
def test_csr_stdp_bitwise(backend, clip, homo):
    shape, w, idx, ptr, pre_s, post_s, pre_t, post_t = _stdp_case(8, homo)
    lo, hi = clip or (None, None)
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.from_numpy(np.asarray(a))
    want_pre = jp.update_csr_on_binary_pre(
        j(w), j(idx), j(ptr), j(pre_s), j(post_t), lo, hi, shape=shape,
        backend=backend)
    got_pre = bt.update_csr_on_binary_pre(
        t(w), t(idx), t(ptr), t(pre_s), t(post_t), lo, hi, shape=shape)
    np.testing.assert_array_equal(got_pre.numpy(), np.asarray(want_pre))
    want_post = jp.update_csr_on_binary_post(
        want_pre, j(idx), j(ptr), None, j(pre_t), j(post_s), lo, hi,
        shape=shape, backend=backend)
    got_post = bt.update_csr_on_binary_post(
        got_pre, t(idx), t(ptr), None, t(pre_t), t(post_s), lo, hi,
        shape=shape)
    np.testing.assert_array_equal(got_post.numpy(), np.asarray(want_post))
    assert got_post.shape == (idx.size,)


@pytest.mark.parametrize('backend', ['pallas', 'jax_raw'])
@pytest.mark.parametrize('clip', [None, (0.1, 0.9)], ids=['free', 'clip'])
def test_csc_stdp_bitwise(backend, clip):
    (m, k), w, idx, ptr, pre_s, post_s, pre_t, post_t = _stdp_case(9, False)
    # the structure as CSC of a (k, m) logical matrix: pre is its columns
    lo, hi = clip or (None, None)
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.from_numpy(np.asarray(a))
    shape = (k, m)
    want = jp.update_csc_on_binary_pre(j(w), j(idx), j(ptr), j(post_s),
                                       j(pre_t), lo, hi, shape=shape,
                                       backend=backend)
    got = bt.update_csc_on_binary_pre(t(w), t(idx), t(ptr), t(post_s),
                                      t(pre_t), lo, hi, shape=shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jp.update_csc_on_binary_post(want, j(idx), j(ptr), j(post_t),
                                        j(pre_s), lo, hi, shape=shape,
                                        backend=backend)
    got = bt.update_csc_on_binary_post(got, t(idx), t(ptr), t(post_t),
                                       t(pre_s), lo, hi, shape=shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stdp_gradient_is_identity_in_the_weight():
    shape, w, idx, ptr, pre_s, _, _, post_t = _stdp_case(10, False)
    wt = torch.from_numpy(w).requires_grad_(True)
    trace = torch.from_numpy(post_t).requires_grad_(True)
    out = bt.update_csr_on_binary_pre(wt, torch.from_numpy(idx),
                                      torch.from_numpy(ptr),
                                      torch.from_numpy(pre_s), trace,
                                      shape=shape)
    ct = torch.arange(out.shape[0], dtype=torch.float32)
    g_w, g_t = torch.autograd.grad(out, (wt, trace), ct, allow_unused=True)
    assert torch.equal(g_w, ct) and g_t is None
    # a homogeneous weight is broadcast first: its gradient is the sum
    w1 = torch.tensor([0.5], requires_grad=True)
    out = bt.update_csr_on_binary_pre(w1, torch.from_numpy(idx),
                                      torch.from_numpy(ptr),
                                      torch.from_numpy(pre_s), trace,
                                      shape=shape)
    (g,) = torch.autograd.grad(out.sum(), w1)
    assert g.shape == (1,) and float(g) == idx.size
