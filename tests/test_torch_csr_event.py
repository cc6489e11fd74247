# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The CSR matvecs of brainevent_torch (twins of K7 ``csr_gather_mv`` and
K8 ``csr_scatter_mv``) against brainevent_tpu on the CPU.

Inputs come from numpy with a seed and go through both packages. K7's twin
is held against the TPU kernel ``csr_event_gather_kernel`` itself (Pallas
in interpret mode, under ``jax.jit`` so that each dtype compiles once) and
against the ``jax_raw`` route. Tolerances: homogeneous binary products
count and scale once, as the Pallas kernel does, so they equal it bitwise;
the ``jax_raw`` route adds ``w`` per event (rtol 1e-6). Heterogeneous and
float products sum in another order than JAX: rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.csr import pallas_kernels as pk
from brainevent_tpu.csr import binary as jb
from brainevent_tpu.csr import float as jf
from brainevent_tpu.csr.pallas_kernels import csr_event_gather_kernel

from _torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
M, K = 120, 150
RATES = [0.0, 0.05, 1.0]


def _structure(seed=0, m=M, k=K):
    """A CSR structure with empty rows, trailing empty rows included."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, m)
    counts[[0, 5, 17]] = 0
    counts[-3:] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, k, indptr[-1]).astype(np.int32)
    return indptr, indices, rng


def _weights(rng, nse, homo):
    return (np.array([0.37], np.float32) if homo
            else rng.normal(size=nse).astype(np.float32))


def _spikes(rng, n, rate, kind):
    on = rng.random(n) < rate
    if kind == 'bool':
        return on
    return np.where(on, rng.random(n) + 0.5, -rng.random(n)).astype(
        np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope='module')
def pallas_gather():
    """The TPU kernel, jitted: one compile per (weights, spikes) dtype."""
    fn = csr_event_gather_kernel(
        shape=(M, K), outs=[jax.ShapeDtypeStruct((M,), jnp.float32)],
        transpose=False)
    return jax.jit(fn)


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
def test_k7_twin_matches_pallas_kernel(pallas_gather, kind, homo):
    indptr, indices, rng = _structure(1)
    w = _weights(rng, indices.size, homo)
    for rate in RATES:
        s = _spikes(rng, K, rate, kind)
        out = pallas_gather(jnp.asarray(w), jnp.asarray(indices),
                            jnp.asarray(indptr), jnp.asarray(s))
        assert out is not None          # inside the kernel's guard
        want = np.asarray(out[0])
        got = pk.csr_gather_mv(*_t(indptr, indices), None, *_t(w, s), True)
        if homo:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize('rate', RATES)
@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [False, True], ids=['K7', 'K8'])
def test_binary_csrmv_matches_jax_raw(rate, kind, homo, transpose):
    indptr, indices, rng = _structure(2)
    w = _weights(rng, indices.size, homo)
    s = _spikes(rng, M if transpose else K, rate, kind)
    (want,) = jb.binary_csrmv_p_call(
        jnp.asarray(w), jnp.asarray(indices), jnp.asarray(indptr),
        jnp.asarray(s), shape=(M, K), transpose=transpose, backend='jax_raw')
    got = bt.binary_csrmv(*_t(w, indices, indptr, s), shape=(M, K),
                          transpose=transpose, backend='pallas')
    assert got.shape == want.shape and got.dtype == torch.float32
    rtol = 1e-6 if homo else RTOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=ATOL)


@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [False, True], ids=['K7', 'K8'])
def test_binary_csrmv_indexed_matches_jax(homo, transpose):
    indptr, indices, rng = _structure(3)
    w = _weights(rng, indices.size, homo)
    perm = rng.permutation(indices.size).astype(np.int32)
    s = _spikes(rng, M if transpose else K, 0.3, 'bool')
    (want,) = jb.binary_csrmv_indexed_p_call(
        *map(jnp.asarray, (w, indices, indptr, perm, s)), shape=(M, K),
        transpose=transpose)
    got = bt.binary_csrmv_indexed(*_t(w, indices, indptr, perm, s),
                                  shape=(M, K), transpose=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [False, True], ids=['K7', 'K8'])
def test_csrmv_matches_jax(homo, transpose):
    indptr, indices, rng = _structure(4)
    w = _weights(rng, indices.size, homo)
    v = rng.normal(size=M if transpose else K).astype(np.float32)
    v[::7] = 0.0                        # K8 skips these rows
    want = jf.csrmv(*map(jnp.asarray, (w, indices, indptr, v)),
                    shape=(M, K), transpose=transpose)
    got = bt.csrmv(*_t(w, indices, indptr, v), shape=(M, K),
                   transpose=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_k7_over_the_mirror_matches_k8():
    """The transposed float matvec of a CSR with its mirror built (K7
    through ``perm``) against the one without (K8)."""
    indptr, indices, rng = _structure(5)
    w = _weights(rng, indices.size, False)
    A = bt.CSR(_t(w, indices, indptr), shape=(M, K))
    u = torch.from_numpy(rng.normal(size=M).astype(np.float32))
    plain = u @ A
    B = A.with_data(A.data).build_weight_indices()
    mirrored = u @ B
    np.testing.assert_allclose(mirrored.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    dense = A.todense().numpy()
    np.testing.assert_allclose(mirrored.numpy(), u.numpy() @ dense,
                               rtol=RTOL, atol=ATOL)


def test_out_of_range_ids_are_dropped():
    indptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    indices = torch.tensor([1, 7, -1], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 4.0])
    x = torch.ones(3)
    assert pk.csr_gather_mv(indptr, indices, None, w, x, False).tolist() == [
        1.0, 0.0]
    y = pk.csr_scatter_mv(indptr, indices, None, w, torch.ones(2), False, 3)
    assert y.tolist() == [0.0, 1.0, 0.0]
