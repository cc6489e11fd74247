# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The light RNG and the walk setup of brainevent_torch against
brainevent_tpu on the CPU: every draw bitwise (the normal variate's tails
within 7 ulp, see ``brainevent_torch/rng/light.py``), over 1M random
uint32 inputs with the edge values ``0``, ``1``, ``2^31`` and ``2^32 - 1``
(and bounds near ``2^32``) among them; the plans' stream setup bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainevent_tpu.jitc import pallas_kernels as jpk
from brainevent_tpu.rng import light as jl
from brainevent_torch.jitc import engine
from brainevent_torch.jitc import pallas_kernels as tpk
from brainevent_torch.rng import light as tl

from _torch_one_thread import one_torch_thread  # noqa: F401

N = 1 << 20
EDGES = np.array([0, 1, 2, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFE], np.uint32)


def _u32(rng, n=N, edges=EDGES):
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    x[:edges.size] = edges
    return x


@pytest.fixture(scope='module')
def words():
    rng = np.random.default_rng(20261016)
    return [_u32(rng) for _ in range(4)]


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


def _same(j, t):
    return np.array_equal(np.asarray(j), t.numpy().astype(np.uint32))


@pytest.mark.parametrize('name', ['mix32', 'next'])
def test_unary_draws_bitwise(words, name):
    a = words[0]
    j = jax.jit(getattr(jl, f'light_rng_{name}'))(a)
    assert _same(j, getattr(tl, f'light_rng_{name}')(_t(a)))


@pytest.mark.parametrize('name', ['mulhi', 'bounded'])
def test_high_multiply_bitwise(words, name):
    a, b = words[0], words[1].copy()
    b[EDGES.size:EDGES.size + 1000] = 0xFFFFFFFF - np.arange(1000)
    fj = jl._mulhi32 if name == 'mulhi' else jl.light_rng_bounded
    ft = tl._mulhi32 if name == 'mulhi' else tl.light_rng_bounded
    assert _same(jax.jit(fj)(a, b), ft(_t(a), _t(b)))


def test_stream_init_bitwise(words):
    a, b, c = words[:3]
    j = jax.jit(jl.light_rng_init)(np.uint32(7), a, b, c)
    assert _same(j, tl.light_rng_init(7, _t(a), _t(b), _t(c)))


def test_uniform_bitwise(words):
    a, b = words[:2]
    j = np.asarray(jax.jit(jl.light_rng_uniform01)(np.uint32(99), a, b))
    t = tl.light_rng_uniform01(99, _t(a), _t(b)).numpy()
    np.testing.assert_array_equal(j, t)
    assert t.min() >= 0.0 and t.max() < 1.0


def test_normal_central_bitwise_tails_within_7_ulp(words):
    a, b = words[:2]
    j = np.asarray(jax.jit(jl.light_rng_normal01)(np.uint32(99), a, b))
    t = tl.light_rng_normal01(99, _t(a), _t(b)).numpy()
    u = tl.light_rng_uniform01(99, _t(a), _t(b)).numpy()
    central = (u >= np.float32(0.02425)) & (u <= np.float32(0.97575))
    np.testing.assert_array_equal(j[central], t[central])
    ulp = np.abs(j.view(np.int32).astype(np.int64) - t.view(np.int32))
    assert ulp.max() <= 7
    assert (j != t).mean() < 2e-3
    # the same bits on a repeat (PyTorch's float32 log is not)
    assert np.array_equal(t, tl.light_rng_normal01(99, _t(a), _t(b)).numpy())


@pytest.mark.parametrize('cl', ['2', '2001', 'varying', 'near 2^32'])
def test_initial_q_bitwise(words, cl):
    state = words[0]
    if cl == 'varying':
        cl = (words[1] % 5000 + 2).astype(np.uint32)
    elif cl == 'near 2^32':
        cl = np.uint32(0xFFFFFF00)
    else:
        cl = np.uint32(int(cl))
    qj, sj = jax.jit(jl.light_rng_initial_q)(state, cl)
    clt = _t(cl) if isinstance(cl, np.ndarray) else int(cl)
    qt, st = tl.light_rng_initial_q(_t(state), clt)
    assert _same(qj, qt) and _same(sj, st)


# (n_rows, n_cols, logical_cols): the walk of an (m, k) product, and walks
# wider than the logical column count (a transposed product's walk)
WALKS = [(300, 200, 200), (257, 1000, 1000), (64, 4000, 4000),
         (200, 300, 200), (1000, 257, 1001)]


@pytest.mark.parametrize('stride', [32, 4], ids=['mv', 'mm'])
@pytest.mark.parametrize('walk', WALKS, ids=lambda w: 'x'.join(map(str, w)))
def test_walk_plan_setup_bitwise(walk, stride):
    n_rows, n_cols, logical = walk
    chunk = -(-logical // 4)
    jfn = jpk.walk_plan_setup if stride == 32 else jpk.walk_plan_setup_mm
    tfn = tpk.walk_plan_setup if stride == 32 else tpk.walk_plan_setup_mm
    sj, qj, clj = jfn(np.uint32(1234), np.uint32(20), n_rows, n_cols, chunk)
    st, qt, cl = tfn(1234, 20, n_rows, n_cols, chunk, device='cpu')
    assert st.dtype == torch.int32 and st.shape == np.asarray(sj).shape
    assert np.array_equal(np.asarray(sj).view(np.int32), st.numpy())
    assert np.array_equal(np.asarray(qj).view(np.int32), qt.numpy())
    assert cl == int(clj) == 20


def test_setup_of_selected_rows_is_the_plans_rows():
    chunk = 50
    st, qt, _ = tpk.walk_plan_setup(5, 30, 40, 200, chunk, device='cpu')
    rows = torch.tensor([3, 17, 39])
    _, _, _, s, q, _ = engine.walk_setup(5, 30, 40, 200, 32, chunk, rows=rows)
    assert torch.equal(engine.to_int32(s).reshape(3, -1), st[rows])
    assert torch.equal(engine.to_int32(q).reshape(3, -1), qt[rows])


def test_conn_length_rounds_in_float32():
    from brainevent_tpu._misc import _initialize_conn_length as jclen
    from brainevent_torch._misc import _initialize_conn_length as tclen
    for prob in (0.001, 0.02, 0.1, 0.15, 0.3, 1 / 3, 0.7, 1.0, 2e-5,
                 80 / 80000, 80 / 4000, 80 / 200):
        assert tclen(prob) == int(np.asarray(jclen(prob))[0]), prob


def test_uniform_is_exact_24_bits():
    rows = torch.arange(100_000)
    u = tl.light_rng_uniform01(3, rows, rows * 7)
    k = (u.double() * 16777216.0)
    assert torch.equal(k, torch.round(k))


def test_zero_state_escapes():
    assert int(tl.light_rng_next(0)) == int(np.asarray(jl.light_rng_next(
        jnp.uint32(0))))
