# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""``binary_fcnmv`` of brainevent_torch against brainevent_tpu on the CPU.

The JAX side runs both of its backends: ``'pallas'`` (the event kernels of
``fcn/pallas_kernels.py``, in interpret mode) and ``'jax_raw'`` (its XLA
formulation); the port runs the twins of K5 and K6. Homogeneous weights
count hits and scale once, so they must be exact. The homogeneous weight
has three fraction bits, so that the JAX XLA route, which adds the weight
itself once per hit, is exact at any add order too. Heterogeneous sums run
in another order: rtol 1e-5 (atol 1e-6 for sums near 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.fcn import binary as tb
from brainevent_tpu.fcn.binary import binary_fcnmv_p_call as jax_fcnmv

from _torch_one_thread import one_torch_thread  # noqa: F401

N_PRE, N_POST, K = 300, 260, 16


def _inputs(rate, homo, spike_dtype, transpose, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_POST, (N_PRE, K)).astype(np.int32)
    if homo:
        w = np.array([np.round(rng.normal() * 8) / 8 + 0.125], np.float32)
    else:
        w = rng.normal(size=(N_PRE, K)).astype(np.float32)
    n_s = N_PRE if transpose else N_POST
    on = rng.random(n_s) < rate
    if spike_dtype == 'bool':
        s = on
    else:   # float spikes: inactive entries are 0 or negative (s > 0 gates)
        s = np.where(on, rng.uniform(0.5, 2.0, n_s),
                     -rng.random(n_s) * (rng.random(n_s) < 0.5))
        s = s.astype(np.float32)
    return w, idx, s


@pytest.mark.parametrize('backend', ['pallas', 'jax_raw'])
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('spike_dtype', ['bool', 'float'])
@pytest.mark.parametrize('rate', [0.0, 0.01, 1.0])
def test_binary_fcnmv_matches_jax(rate, spike_dtype, homo, transpose,
                                  backend):
    w, idx, s = _inputs(rate, homo, spike_dtype, transpose)
    (want,) = jax_fcnmv(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(s),
                        shape=(N_PRE, N_POST), transpose=transpose,
                        backend=backend)
    got = bt.binary_fcnmv(torch.from_numpy(w), torch.from_numpy(idx),
                          torch.from_numpy(s), shape=(N_PRE, N_POST),
                          transpose=transpose, backend=backend)
    assert got.shape == (N_POST if transpose else N_PRE,)
    assert got.dtype == torch.float32
    if homo:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_binary_fcnmv_matches_dense(transpose):
    w, idx, s = _inputs(0.2, False, 'bool', transpose, seed=7)
    dense = np.zeros((N_PRE, N_POST), np.float64)
    np.add.at(dense, (np.repeat(np.arange(N_PRE), K), idx.reshape(-1)),
              w.reshape(-1))
    want = s @ dense if transpose else dense @ s
    got = bt.binary_fcnmv(torch.from_numpy(w), torch.from_numpy(idx),
                          torch.from_numpy(s), shape=(N_PRE, N_POST),
                          transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_out_of_range_targets_are_dropped(transpose):
    w, idx, s = _inputs(0.5, False, 'bool', transpose, seed=8)
    bad = idx.copy()
    bad[::3, 0] = -1
    bad[1::3, 1] = N_POST + 5
    kept = np.where((bad >= 0) & (bad < N_POST), w, 0).astype(np.float32)
    got = bt.binary_fcnmv(torch.from_numpy(w), torch.from_numpy(bad),
                          torch.from_numpy(s), shape=(N_PRE, N_POST),
                          transpose=transpose)
    want = bt.binary_fcnmv(torch.from_numpy(kept),
                           torch.from_numpy(np.clip(bad, 0, N_POST - 1)),
                           torch.from_numpy(s), shape=(N_PRE, N_POST),
                           transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
def test_backward_raises_unsupported(homo):
    w, idx, s = _inputs(0.3, homo, 'float', True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = bt.binary_fcnmv(wt, torch.from_numpy(idx), torch.from_numpy(s),
                        shape=(N_PRE, N_POST), transpose=True)
    with pytest.raises(bt.UnsupportedOperationError, match='fcn/float.py'):
        y.sum().backward()


def test_shape_checks():
    w, idx, s = _inputs(0.3, True, 'bool', True)
    w, idx, s = map(torch.from_numpy, (w, idx, s))
    with pytest.raises(bt.MathError, match='shape\\[0\\]'):
        bt.binary_fcnmv(w, idx, s, shape=(N_PRE + 1, N_POST), transpose=True)
    with pytest.raises(bt.MathError, match='operand length'):
        bt.binary_fcnmv(w, idx, s, shape=(N_PRE, N_POST), transpose=False)
    with pytest.raises(ValueError, match='weights must be'):
        bt.binary_fcnmv(torch.ones(3), idx, s, shape=(N_PRE, N_POST),
                        transpose=True)
    # an integer index table and a scalar weight are accepted
    (y,) = bt.binary_fcnmv_p_call(0.5, idx.long(), s, shape=(N_PRE, N_POST),
                                  transpose=True)
    assert y.shape == (N_POST,)


def test_homogeneous_twins_count_then_scale():
    idx = torch.tensor([[0, 1, 1], [1, 2, 0]], dtype=torch.int32)
    s = torch.tensor([True, True])
    w = torch.tensor([0.1])
    y = tb.fcn_event_scatter_twin(w, idx, s, 3)
    np.testing.assert_array_equal(
        y.numpy(), np.float32([2, 3, 1]) * np.float32(0.1))
    y = tb.fcn_event_gather_twin(w, idx, torch.tensor([True, False, True]), 3)
    np.testing.assert_array_equal(y.numpy(),
                                  np.float32([1, 2]) * np.float32(0.1))
