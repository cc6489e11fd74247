# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Gather plans of brainevent_torch against brainevent_tpu on the CPU.

The plan layout is the interface the two packages share, so ``meta``,
``b0``, ``rb``, ``perm`` and the static fields must be bitwise equal. The
JAX side runs its Pallas kernels in interpret mode; the port runs its
twins of K3 (``gather_matvec``) and K4 (``plan_matvec_dw``). The sums run
in another order than the JAX kernel's, hence rtol 1e-5 / atol 1e-6 on
``y``; ``dw`` is one product per slot and must be bitwise equal. K3 reads
the weights in row order (``sort_rows``): its twin adds each row's slots
in the order the plan-order twin ``gather_matvec_xla`` adds them, so the
two are bitwise equal here.
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


# plans from ELL tables (even rows) beside CASES' COO structures (uneven)
ELL_CASES = {'ell_square': ((200, 150), 6), 'ell_one': ((64, 64), 1),
             'ell_wide': ((1100, 300), 9)}


def _plan_and_data(name, seed=6):
    rng = np.random.default_rng(seed)
    if name in ELL_CASES:
        shape, k = ELL_CASES[name]
        plan = tg.plan_from_ell(rng.integers(0, shape[1], (shape[0], k)),
                                shape)
    else:
        rows, cols, shape, kw, rng = _coo(name, seed)
        plan = tg.build_gather_plan(rows, cols, shape, **kw)
    data = rng.normal(size=plan.nse).astype(np.float32)
    x = rng.normal(size=plan.shape[1]).astype(np.float32)
    return plan, torch.from_numpy(data), torch.from_numpy(x)


@pytest.mark.parametrize('name', sorted(CASES) + sorted(ELL_CASES))
def test_sort_rows_is_sort_data_then_row_slots(name):
    plan, data, _ = _plan_and_data(name)
    w_row = plan.sort_rows(data)
    assert w_row.dtype == torch.float32 and w_row.shape == (plan.nse,)
    want = plan.sort_data(data).reshape(-1)[plan.row_slots.long()]
    assert torch.equal(w_row, want)
    assert torch.equal(plan.rows_of(plan.sort_data(data)), want)
    assert torch.equal(plan.row_src, plan.perm.reshape(-1)[
        plan.row_slots.long()])
    homo = plan.sort_rows(torch.tensor([2.5], dtype=torch.float64))
    assert homo.dtype == torch.float32 and bool((homo == 2.5).all())
    assert homo.shape == (plan.nse,)


@pytest.mark.parametrize('name', sorted(CASES) + sorted(ELL_CASES))
def test_row_twin_bitwise_the_plan_order_twin(name):
    plan, data, x = _plan_and_data(name)
    got = tg.gather_matvec_rows(plan, plan.sort_rows(data), x)
    want = tg.gather_matvec_xla(plan, plan.sort_data(data), x)
    assert torch.equal(got, want)
    assert torch.equal(bt.gather_matvec(plan, plan.sort_data(data), x), want)


@pytest.mark.parametrize('name', sorted(ELL_CASES))
def test_plan_matvec_rows_is_plan_matvec_vjp(name):
    """The row-order entry the CSR matrix's plan route calls gives
    :func:`plan_matvec_vjp`'s values and cotangents."""
    plan, data, x = _plan_and_data(name)
    rows, cols = tg._decode(plan)
    valid = plan.perm >= 0
    plan_t = tg.build_gather_plan(cols[valid].numpy(), rows[valid].numpy(),
                                  plan.shape[::-1])
    # data in the flat order of the transposed plan's build
    data_t = data[plan.perm[valid].long()]
    vv = [x.clone().requires_grad_(True) for _ in range(2)]
    ct = torch.from_numpy(np.random.default_rng(7).normal(
        size=plan.shape[0]).astype(np.float32))
    ya = bt.plan_matvec_vjp(plan, plan_t, plan.sort_data(data),
                            plan_t.sort_data(data_t), vv[0])
    yb = tg.plan_matvec_rows(plan, plan_t, plan.sort_rows(data),
                             plan_t.sort_rows(data_t), vv[1])
    assert torch.equal(ya, yb)
    (ga,) = torch.autograd.grad(ya, vv[0], ct)
    (gb,) = torch.autograd.grad(yb, vv[1], ct)
    assert torch.equal(ga, gb)


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


@pytest.mark.parametrize('name', sorted(CASES))
def test_plan_matvec_dw_row_view(name):
    """``plan_matvec_dw`` given the row view K4 reads (``sort_rows``, or
    ``rows_of`` the plan-order weights) is bitwise the call without it,
    and within tolerance of the JAX package's."""
    jp, tp, data, x, s, _, _ = _operands(name)
    d = torch.from_numpy(data)
    args = (tp, tp.sort_data(d), torch.from_numpy(s), torch.from_numpy(x))
    y, dw = bt.plan_matvec_dw(*args)
    for w_row in (tp.sort_rows(d), tp.rows_of(tp.sort_data(d))):
        yv, dwv = bt.plan_matvec_dw(*args, w_row=w_row)
        assert torch.equal(yv, y) and torch.equal(dwv, dw)
    jy, _ = jg.plan_matvec_dw(jp, jp.sort_data(jnp.asarray(data)),
                              jnp.asarray(s), jnp.asarray(x))
    np.testing.assert_allclose(yv.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def _every_plan(name):
    """The plan of a case: ``ELL_CASES``' tables, ``CASES``' structures
    with their knobs, and (``mm_`` names) with the mat-mat plan's."""
    if name in ELL_CASES:
        return _plan_and_data(name)[0]
    mm = name.startswith('mm_')
    rows, cols, shape, kw, _ = _coo(name[3:] if mm else name)
    if mm:
        return tg.build_mm_plan(rows, cols, shape)
    return tg.build_gather_plan(rows, cols, shape, **kw)


@pytest.mark.parametrize('name', sorted(CASES) + sorted(ELL_CASES)
                         + ['mm_' + n for n in sorted(CASES)])
def test_n_valid_counts_a_prefix_of_each_chunk(name):
    """A chunk's valid slots are its first ``n_valid`` slots: K4's dw pass
    writes 0 past them without reading ``perm``."""
    plan = _every_plan(name)
    valid = plan.perm >= 0
    assert plan.n_valid.dtype == torch.int32
    assert plan.n_valid.shape == (plan.n_chunks,)
    assert torch.equal(plan.n_valid, valid.sum(1).to(torch.int32))
    slot = torch.arange(plan.chunk)[None, :]
    assert torch.equal(valid, slot < plan.n_valid[:, None])
    assert int(plan.n_valid.sum()) == plan.nse


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
