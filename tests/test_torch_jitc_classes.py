# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The JITC matrix classes and walk plans of brainevent_torch against
brainevent_tpu on the CPU: ``todense`` of ``R``/``C`` and of the mode
views (scalar and uniform bitwise, normal as in ``test_torch_jitc.py``),
every ``@`` route within ``1e-5 * sum|w x|``, the plan products in both
directions, and the ctypes signatures of the walk kernels' wrappers."""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_tpu as be
import brainevent_torch as bt
from brainevent_torch.jitc import pallas_kernels as pk
from brainevent_torch.ops import cuda_build

from test_torch_jitc import _bound_ok, assert_dense_equal
from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PROB, SEED = 0.1, 77
SHAPE = (257, 1000)
LAWS = {'scalar': ('JITCScalar', (0.6,)),
        'normal': ('JITCNormal', (0.6, 0.06)),
        'uniform': ('JITCUniform', (0.48, 0.72))}


def _pair(law, orient='R', corder=True, shape=SHAPE):
    name, params = LAWS[law]
    data = (*params, PROB, SEED)
    jm = getattr(be.jitc, f'{name}{orient}')(data, shape=shape, corder=corder)
    tm = getattr(bt, f'{name}{orient}')(data, shape=shape, corder=corder,
                                        device='cpu')
    return jm, tm


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize('corder', [True, False], ids=['corder', 'rorder'])
@pytest.mark.parametrize('orient', ['R', 'C'])
@pytest.mark.parametrize('law', list(LAWS))
def test_todense_and_mode_views(law, orient, corder):
    jm, tm = _pair(law, orient, corder)
    for get in (lambda m: m.todense(), lambda m: m.mv.todense(),
                lambda m: m.mm.todense()):
        got, want = get(tm).numpy(), _np(get(jm))
        assert got.shape == want.shape == SHAPE
        assert_dense_equal(law, got, want)
    assert not np.array_equal(tm.mv.todense().numpy(),
                              tm.mm.todense().numpy())


@pytest.mark.parametrize('orient', ['R', 'C'])
@pytest.mark.parametrize('law', list(LAWS))
def test_matmul_routes(law, orient):
    jm, tm = _pair(law, orient)
    rng = np.random.default_rng(3)
    m, k = SHAPE
    D = np.abs(tm.todense().numpy())
    Dmm = np.abs(tm.mm.todense().numpy())
    v, u = rng.normal(size=k).astype(np.float32), rng.normal(
        size=m).astype(np.float32)
    spk_k, spk_m = rng.random(k) < 0.2, rng.random(m) < 0.2
    B, X = (rng.normal(size=(k, 8)).astype(np.float32),
            rng.normal(size=(5, m)).astype(np.float32))
    cases = [
        ('M @ v', lambda M, A: M @ A(v), D @ np.abs(v)),
        ('u @ M', lambda M, A: A(u) @ M, np.abs(u) @ D),
        ('M @ spk', lambda M, A: M @ A.ev(spk_k), D @ spk_k),
        ('spk @ M', lambda M, A: A.ev(spk_m) @ M, spk_m @ D),
        ('M @ B', lambda M, A: M @ A(B), Dmm @ np.abs(B)),
        ('X @ M', lambda M, A: A(X) @ M, np.abs(X) @ Dmm),
    ]

    class J:
        __call__ = staticmethod(jnp.asarray)
        ev = staticmethod(lambda x: be.BinaryArray(jnp.asarray(x)))

    class T:
        __call__ = staticmethod(torch.from_numpy)
        ev = staticmethod(lambda x: bt.BinaryArray(torch.from_numpy(x)))

    for what, fn, bound in cases:
        _bound_ok(fn(tm, T()), fn(jm, J()), bound, (law, orient, what))


@pytest.mark.parametrize('law', list(LAWS))
def test_walk_plan_products(law):
    jm, tm = _pair(law)
    jp, tp = jm.build_walk_plan(), tm.build_walk_plan()
    assert tp.setup[0].dtype == torch.int32
    for j, t in zip(jp.setup[:2], tp.setup[:2]):
        assert np.array_equal(_np(j).view(np.int32), t.numpy())
    assert tp.setup[2] == int(np.asarray(jp.setup[2]).reshape(-1)[0])
    rng = np.random.default_rng(4)
    m, k = SHAPE
    D = np.abs(tm.todense().numpy())
    v = rng.normal(size=k).astype(np.float32)
    spk = rng.random(m) < 0.05
    B = rng.normal(size=(k, 6)).astype(np.float32)
    _bound_ok(tp @ torch.from_numpy(v), jp @ jnp.asarray(v),
              D @ np.abs(v), 'plan @ v')
    _bound_ok(bt.BinaryArray(torch.from_numpy(spk)) @ tp,
              be.BinaryArray(jnp.asarray(spk)) @ jp, spk @ D, 'spk @ plan')
    # a 2-D operand applies the mv-mode matrix to every column
    _bound_ok(tp @ torch.from_numpy(B), jp @ jnp.asarray(B),
              D @ np.abs(B), 'plan @ B')


def test_scalar_algebra_and_transpose():
    jm, tm = _pair('uniform')
    for op in (lambda M: M * 2.0, lambda M: 3.0 * M, lambda M: M / 4.0,
               lambda M: -M, lambda M: M + 0.25, lambda M: M - 0.25):
        assert_dense_equal('uniform', op(tm).todense().numpy(),
                           _np(op(jm).todense()))
    jn, tn = _pair('normal')
    assert tuple((tn + 1.0).data) == (1.6, 0.06)
    assert_dense_equal('normal', (tn + 1.0).todense().numpy(),
                       _np((jn + 1.0).todense()), loc=1.6)
    t = tm.transpose()
    assert type(t).__name__ == 'JITCUniformC' and t.shape == SHAPE[::-1]
    np.testing.assert_array_equal(t.todense().numpy(),
                                  tm.todense().numpy().T)
    assert type(t.T).__name__ == 'JITCUniformR'


def test_generative_matrices_refuse_structure_ops():
    _, tm = _pair('scalar')
    with pytest.raises(bt.UnsupportedOperationError):
        bt.JITCScalarR.fromdense(torch.eye(3))
    for fn in (tm.tocsr, tm.mv.tocsr, tm.update_on_pre):
        with pytest.raises(bt.UnsupportedOperationError):
            fn()
    with pytest.raises(bt.MathError):
        bt.JITCScalarR((0.5, PROB), shape=(3, 4), device='cpu')


def test_auto_plan_is_built_once_and_can_be_turned_off():
    """``M @ v`` builds the plan once and keeps it; the functional product,
    which takes no plan, gives the same result."""
    _, tm = _pair('scalar')
    v = torch.ones(SHAPE[1])
    got = tm @ v
    plan = tm._plan_cache
    tm @ v
    assert plan is not None and tm._plan_cache is plan
    torch.testing.assert_close(
        got, bt.jitsmv(*LAWS['scalar'][1], PROB, v, SEED, shape=SHAPE),
        rtol=1e-6, atol=1e-5)


def _c_params(name):
    text = (ROOT / 'brainevent_torch' / 'csrc' / 'jitc_walk.cu').read_text()
    sig = text[text.index(f' {name}(') + len(name) + 2:]
    return sig[:sig.index(')')].count(',') + 1


def test_wrappers_pass_what_the_c_entry_points_take(monkeypatch):
    """Each walk wrapper declares as many ctypes arguments as its C entry
    point has parameters, and passes that many."""
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = len(argtypes)
            return 0
        return fn

    monkeypatch.setattr(cuda_build, 'function', function)
    monkeypatch.setattr(pk, 'cuda_stream', lambda device: None)
    st = torch.zeros(4, 128, dtype=torch.int32)     # 4 chunks x 32 lanes
    law = dict(law=1, a=0.5, b=0.1, seed=3, cl=20)
    walk = dict(n_rows=4, n_cols=8, logical_cols=8, corder=False, event=True)
    for op, args, kw in (
            (pk.jitc_walk_setup, (st, st.clone()),
             dict(seed=3, cl=20, n_rows=4, n_cols=8, chunk_size=2,
                  stride=32)),
            (pk.jitc_walk_mv, (st, st.clone(), torch.ones(4) > 0),
             {**law, **walk}),
            (pk.jitc_walk_mm, (None, None, torch.ones(4, 3)),
             {**law, **walk}),
            (pk.jitc_walk_todense, (torch.zeros(8, 4), None, None),
             dict(law, corder=True))):
        op.cuda(op, *args, **kw)
    assert set(seen) == {'jitc_walk_setup_launch', 'jitc_walk_mv_launch',
                         'jitc_walk_mm_launch', 'jitc_walk_todense_launch'}
    for name, n in seen.items():
        assert _c_params(name) == n, name
