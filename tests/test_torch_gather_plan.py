# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Gather plans of brainevent_torch against brainevent_tpu on the CPU.

The plan layout is the interface the two packages share, so ``meta``,
``b0``, ``rb``, ``perm`` and the static fields must be bitwise equal. The
JAX side runs its Pallas kernels in interpret mode; the port runs its
twins of K3 (``gather_matvec``) and K4 (``plan_matvec_dw``). The sums run
in another order than the JAX kernel's, hence rtol 1e-5 / atol 1e-6 on
``y``; ``dw`` is one product per slot and must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.ops import mxu_gather as tg
from brainevent_tpu.ops import mxu_gather as jg

from _torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6

# (shape, nse, plan knobs): square, rectangular, sizes off the 128 grid,
# several row blocks and windows, and an empty structure
CASES = {
    'square': ((256, 256), 3000, {}),
    'rect': ((300, 1000), 2500, {}),
    'odd': ((129, 77), 700, {}),
    'row_blocks': ((1000, 700), 6000, dict(row_block=128, win_blocks=2)),
    'small_chunks': ((517, 333), 4000, dict(chunk=128, row_block=256)),
    'empty': ((40, 50), 0, {}),
}


def _coo(name, seed=0):
    shape, nse, kw = CASES[name]
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, shape[0], nse)
    cols = rng.integers(0, shape[1], nse)
    return rows, cols, shape, kw, rng


def _assert_plans_equal(jp, tp):
    for field in ('meta', 'b0', 'rb', 'perm'):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)),
                                      err_msg=field)
        assert getattr(tp, field).dtype == torch.int32
    assert tg.plan_aux(tp) == jg.plan_aux(jp)
    assert tp.n_chunks == jp.n_chunks


@pytest.mark.parametrize('name', sorted(CASES))
def test_build_gather_plan_bitwise(name):
    rows, cols, shape, kw, _ = _coo(name)
    _assert_plans_equal(jg.build_gather_plan(rows, cols, shape, **kw),
                        tg.build_gather_plan(rows, cols, shape, **kw))


@pytest.mark.parametrize('shape,k', [((200, 150), 6), ((64, 64), 1),
                                     ((1100, 300), 9)])
def test_plan_from_ell_bitwise(shape, k):
    rng = np.random.default_rng(1)
    ell = rng.integers(0, shape[1], (shape[0], k))
    _assert_plans_equal(jg.plan_from_ell(ell, shape),
                        tg.plan_from_ell(ell, shape))


def test_plan_from_csr_bitwise():
    rng = np.random.default_rng(2)
    shape = (300, 260)
    counts = rng.integers(0, 12, shape[0])
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, shape[1], indptr[-1])
    _assert_plans_equal(jg.plan_from_csr(indices, indptr, shape),
                        tg.plan_from_csr(indices, indptr, shape))


@pytest.mark.parametrize('name', sorted(CASES))
def test_row_index_lists_each_valid_slot_of_its_row(name):
    rows, cols, shape, kw, _ = _coo(name)
    plan = tg.build_gather_plan(rows, cols, shape, **kw)
    perm = plan.perm.numpy().reshape(-1)
    ptr, slots = plan.row_ptr.numpy(), plan.row_slots.numpy()
    assert ptr[0] == 0 and ptr[-1] == plan.nse == slots.size
    assert sorted(slots) == list(np.flatnonzero(perm >= 0))
    for r in range(shape[0]):
        mine = slots[ptr[r]:ptr[r + 1]]
        assert (np.diff(mine) > 0).all()
        assert (rows[perm[mine]] == r).all()


@pytest.mark.parametrize('name', sorted(CASES))
def test_inverse_perm_and_sort_data(name):
    rows, cols, shape, kw, rng = _coo(name)
    jp = jg.build_gather_plan(rows, cols, shape, **kw)
    tp = tg.build_gather_plan(rows, cols, shape, **kw)
    inv = tg.plan_inverse_perm(tp)
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(jg.plan_inverse_perm(jp)))
    data = rng.normal(size=len(rows)).astype(np.float32)
    ws = tp.sort_data(torch.from_numpy(data))
    np.testing.assert_array_equal(ws.numpy(),
                                  np.asarray(jp.sort_data(jnp.asarray(data))))
    np.testing.assert_array_equal(ws.reshape(-1)[inv.long()].numpy(), data)


def test_sort_data_homogeneous_broadcast():
    ell = np.random.default_rng(3).integers(0, 64, (64, 4))
    jp, tp = jg.plan_from_ell(ell, (64, 64)), tg.plan_from_ell(ell, (64, 64))
    w = tp.sort_data(torch.tensor([2.5]))
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jp.sort_data(jnp.asarray([2.5], jnp.float32))))
    valid = tp.perm >= 0
    assert (w[valid] == 2.5).all() and (w[~valid] == 0).all()


def _operands(name, seed=4):
    rows, cols, shape, kw, rng = _coo(name, seed)
    jp = jg.build_gather_plan(rows, cols, shape, **kw)
    tp = tg.build_gather_plan(rows, cols, shape, **kw)
    data = rng.normal(size=len(rows)).astype(np.float32)
    x = rng.normal(size=shape[1]).astype(np.float32)
    s = (rng.random(shape[0]) < 0.3).astype(np.float32)
    return jp, tp, data, x, s, rows, cols


@pytest.mark.parametrize('name', sorted(CASES))
def test_gather_matvec_matches_jax(name):
    jp, tp, data, x, _, rows, cols = _operands(name)
    want = jg.gather_matvec(jp, jp.sort_data(jnp.asarray(data)),
                            jnp.asarray(x))
    got = bt.gather_matvec(tp, tp.sort_data(torch.from_numpy(data)),
                           torch.from_numpy(x), passes=2, force_xla=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    dense = np.zeros(CASES[name][0], np.float64)
    np.add.at(dense, (rows, cols), data)
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize('name', sorted(CASES))
def test_plan_matvec_dw_matches_jax(name):
    jp, tp, data, x, s, rows, cols = _operands(name)
    jy, jdw = jg.plan_matvec_dw(jp, jp.sort_data(jnp.asarray(data)),
                                jnp.asarray(s), jnp.asarray(x))
    ty, tdw = bt.plan_matvec_dw(tp, tp.sort_data(torch.from_numpy(data)),
                                torch.from_numpy(s), torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    # dw at padding slots is undefined in JAX; read both through inv
    inv = tg.plan_inverse_perm(tp).numpy()
    np.testing.assert_array_equal(tdw.numpy().reshape(-1)[inv],
                                  np.asarray(jdw).reshape(-1)[inv])
    np.testing.assert_array_equal(tdw.numpy().reshape(-1)[inv],
                                  s[rows] * x[cols])
    assert (tdw[tp.perm < 0] == 0).all()


@pytest.mark.parametrize('shape,k', [((200, 150), 6), ((96, 300), 5)])
def test_plan_matvec_vjp_grad_matches_jax(shape, k):
    rng = np.random.default_rng(5)
    ell = rng.integers(0, shape[1], (shape[0], k))
    rows = np.repeat(np.arange(shape[0]), k)
    cols = ell.reshape(-1)
    data = rng.normal(size=rows.size).astype(np.float32)
    v = rng.normal(size=shape[1]).astype(np.float32)
    ct = rng.normal(size=shape[0]).astype(np.float32)

    jf = jg.build_gather_plan(rows, cols, shape)
    jb = jg.build_gather_plan(cols, rows, shape[::-1])
    jwf, jwb = jf.sort_data(jnp.asarray(data)), jb.sort_data(jnp.asarray(data))
    want = jax.grad(lambda vv: jnp.dot(jg.plan_matvec_vjp(
        jf, jb, jwf, jwb, vv), jnp.asarray(ct)))(jnp.asarray(v))

    tf = tg.build_gather_plan(rows, cols, shape)
    tb = tg.build_gather_plan(cols, rows, shape[::-1])
    d = torch.from_numpy(data)
    vv = torch.from_numpy(v).requires_grad_(True)
    y = bt.plan_matvec_vjp(tf, tb, tf.sort_data(d), tb.sort_data(d), vv)
    (got,) = torch.autograd.grad(y, vv, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_plan_to_device_keeps_static_fields():
    plan = tg.plan_from_ell(np.zeros((8, 2), np.int64), (8, 8))
    moved = plan.to('cpu')
    assert tg.plan_aux(moved) == tg.plan_aux(plan)
    for k in plan._TENSORS:
        assert torch.equal(getattr(moved, k), getattr(plan, k))
        assert getattr(moved, k).device == torch.device('cpu')
