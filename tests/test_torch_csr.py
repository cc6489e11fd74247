# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The CSR slice of brainevent_torch against brainevent_tpu on the CPU:
the structure conversions, the ``CSR``/``CSC`` classes, gradients, and a
20-step loop of event products, STDP and mat-mat products.

Structure (``indptr``, ``indices``, the CSC mirror and its ``perm``) and
STDP weights are bitwise equal to the JAX package's; products sum in
another order than JAX, hence rtol 1e-5, atol 1e-5. Gradients with
respect to a homogeneous ``(1,)`` weight are held against a dense oracle,
since the JAX package fails there (fault C1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
import brainevent_tpu as be
from brainevent_torch import _misc as tmisc
from brainevent_torch.ops import mxu_gather as tmg
from brainevent_tpu import _misc as jmisc
from brainevent_tpu.csr import binary as jb
from brainevent_tpu.csr import float as jf

from _torch_one_thread import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5


def _random_csr(seed, m, k, max_per_row=14):
    """A random CSR structure with empty rows (trailing ones too) and
    repeated columns, and heterogeneous weights in [0, 1)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_per_row, m)
    counts[[0, 3]] = 0
    counts[-2:] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, k, indptr[-1]).astype(np.int32)
    return rng.random(indices.size).astype(np.float32), indices, indptr, rng


def _dense_of(w, indices, indptr, shape):
    d = np.zeros(shape, np.float64)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    np.add.at(d, (rows, indices), np.broadcast_to(w, indices.shape))
    return d


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# -- structure -----------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1])
def test_structure_conversions_bitwise(seed):
    _, indices, indptr, _ = _random_csr(seed, 90, 70)
    j_rows, _ = jmisc.csr_to_coo_index(jnp.asarray(indptr),
                                       jnp.asarray(indices))
    t_rows, _ = tmisc.csr_to_coo_index(*_t(indptr, indices))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    want = jmisc.csr_to_csc_index(jnp.asarray(indptr), jnp.asarray(indices),
                                  shape=(90, 70))
    got = tmisc.csr_to_csc_index(*_t(indptr, indices), shape=(90, 70))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_row_ids_mind_empty_rows():
    from brainevent_torch.csr._common import row_ids_from_indptr
    from brainevent_tpu.csr._common import row_ids_from_indptr as jrows
    indptr = np.array([0, 0, 2, 2, 5, 5, 5], np.int32)
    got = row_ids_from_indptr(torch.from_numpy(indptr), 5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrows(jnp.asarray(indptr), 5)))
    assert got.tolist() == [1, 1, 3, 3, 3]


def test_csr_class_matches_jax():
    rng = np.random.default_rng(2)
    dense = ((rng.random((60, 45)) < 0.15) * rng.normal(size=(60, 45))
             ).astype(np.float32)
    J = be.CSR.fromdense(jnp.asarray(dense))
    T = bt.CSR.fromdense(torch.from_numpy(dense))
    for name in ('data', 'indices', 'indptr'):
        np.testing.assert_array_equal(getattr(T, name).numpy(),
                                      np.asarray(getattr(J, name)))
    assert T.indices.dtype == torch.int32 and T.nse == J.nse
    np.testing.assert_array_equal(T.todense().numpy(), dense)
    Jc, Tc = J.tocsc(), T.tocsc()
    for name in ('data', 'indices', 'indptr'):
        np.testing.assert_array_equal(getattr(Tc, name).numpy(),
                                      np.asarray(getattr(Jc, name)))
    np.testing.assert_array_equal(T.weight_indices.numpy(),
                                  np.asarray(J.weight_indices))
    np.testing.assert_array_equal(Tc.todense().numpy(), dense)
    np.testing.assert_array_equal(Tc.tocsr().todense().numpy(), dense)
    assert isinstance(T.T, bt.CSC) and T.T.shape == (45, 60)
    np.testing.assert_array_equal(T.transpose().todense().numpy(), dense.T)
    Cd = bt.CSC.fromdense(torch.from_numpy(dense))
    Jd = be.CSC.fromdense(jnp.asarray(dense))
    for name in ('data', 'indices', 'indptr'):
        np.testing.assert_array_equal(getattr(Cd, name).numpy(),
                                      np.asarray(getattr(Jd, name)))
    # the CSC products against JAX's, every direction and operand kind
    v, u = rng.normal(size=45).astype(np.float32), rng.normal(
        size=60).astype(np.float32)
    X, Z = rng.normal(size=(45, 4)).astype(np.float32), rng.normal(
        size=(3, 60)).astype(np.float32)
    sv = rng.random(45) < 0.3
    for jm, tm in ((Jd, Cd), (Jc, Tc)):
        pairs = [(jm @ jnp.asarray(v), tm @ torch.from_numpy(v)),
                 (jnp.asarray(u) @ jm, torch.from_numpy(u) @ tm),
                 (jm @ jnp.asarray(X), tm @ torch.from_numpy(X)),
                 (jnp.asarray(Z) @ jm, torch.from_numpy(Z) @ tm),
                 (jm @ be.BinaryArray(jnp.asarray(sv)),
                  tm @ bt.BinaryArray(torch.from_numpy(sv)))]
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)


def test_elementwise_algebra_and_with_data():
    w, indices, indptr, _ = _random_csr(3, 20, 30)
    A = bt.CSR(_t(w, indices, indptr), shape=(20, 30)).build_weight_indices()
    assert torch.equal((A * 2.0).data, A.data * 2.0)
    assert torch.equal((1.0 - A).data, 1.0 - A.data)
    assert torch.equal((-A).data, -A.data)
    assert torch.equal((A + A).data, A.data + A.data)
    assert torch.equal(A.apply(torch.sqrt).data, torch.sqrt(A.data))
    B = A.with_data(torch.tensor([0.5]))
    assert B.weight_indices is A.weight_indices     # structure kept
    np.testing.assert_array_equal(
        B.todense().numpy(), _dense_of(np.float32(0.5), indices, indptr,
                                       (20, 30)).astype(np.float32))
    with pytest.raises(bt.MathError):
        A.with_data(torch.ones(3))
    with pytest.raises(bt.UnsupportedOperationError):
        A * torch.ones(2, 2)


def test_binary_array_against_dense_raises():
    """``BinaryArray`` against a dense tensor was refused until the dense
    event products were ported; it now equals ``binary_densemv``/
    ``binary_densemm`` in the JAX package's orientation, and only a
    shape that does not fit raises."""
    rng = np.random.default_rng(21)
    w = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    s, u = torch.tensor([True, False, True, True, False, True]), torch.tensor(
        [0.5, -1.0, 0.0, 2.0, 1.0])
    S, U = torch.from_numpy(rng.random((3, 6)) < 0.5), torch.from_numpy(
        rng.random((5, 4)) < 0.5)
    for got, want in (
            (bt.BinaryArray(s) @ w, bt.binary_densemv(w, s, transpose=True)),
            (w @ bt.BinaryArray(u), bt.binary_densemv(w, u, transpose=False)),
            (bt.BinaryArray(S) @ w,
             bt.binary_densemm(w, S.T, transpose=True).T),
            (w @ bt.BinaryArray(U), bt.binary_densemm(w, U, transpose=False))):
        assert torch.equal(got, want)
    assert torch.equal(bt.BinaryArray(s) @ w, s.float() @ w)
    np.testing.assert_allclose((w @ bt.BinaryArray(u)).numpy(),
                               (w @ (u > 0).float()).numpy(), rtol=1e-6)
    with pytest.raises(bt.MathError):
        bt.BinaryArray(s) @ torch.ones(2, 3)
    with pytest.raises(bt.MathError):
        torch.ones(3, 2) @ bt.BinaryArray(s)


def test_explicit_plan_routes_float_matvecs_through_k3(monkeypatch):
    w, indices, indptr, rng = _random_csr(4, 300, 260)
    J = be.CSR((jnp.asarray(w), jnp.asarray(indices), jnp.asarray(indptr)),
               shape=(300, 260)).build_mxu_plan()
    T = bt.csr_from_arrays(w, indices, indptr, shape=(300, 260),
                           device='cpu')
    T.build_mxu_plan()
    calls = []
    twin = tmg.plan_gather_mv.twin
    monkeypatch.setattr(tmg.plan_gather_mv, 'twin',
                        lambda *a: calls.append(1) or twin(*a))
    v = rng.normal(size=260).astype(np.float32)
    u = rng.normal(size=300).astype(np.float32)
    np.testing.assert_allclose((T @ torch.from_numpy(v)).numpy(),
                               np.asarray(J @ jnp.asarray(v)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose((torch.from_numpy(u) @ T).numpy(),
                               np.asarray(jnp.asarray(u) @ J), rtol=RTOL,
                               atol=ATOL)
    assert len(calls) == 2
    # the plans survive a change of values; a weight needing its gradient
    # takes the CSR kernels, so that it gets one
    T2 = T.with_data(T.data.clone().requires_grad_(True))
    assert T2._mxu_plans is T._mxu_plans
    y = T2 @ torch.from_numpy(v)
    (g,) = torch.autograd.grad(y.sum(), T2.data)
    assert len(calls) == 2 and g.shape == (T.nse,)


# -- gradients -------------------------------------------------------------------

@pytest.mark.parametrize('binary', [False, True], ids=['csrmv', 'binary'])
@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
def test_matvec_grads_match_jax(binary, transpose):
    m, k = 80, 60
    w, indices, indptr, rng = _random_csr(5, m, k)
    v = rng.normal(size=m if transpose else k).astype(np.float32)
    ct = rng.normal(size=k if transpose else m).astype(np.float32)
    jfn, tfn = ((jb.binary_csrmv, bt.binary_csrmv) if binary
                else (jf.csrmv, bt.csrmv))

    def jloss(w_, v_):
        y = jfn(w_, jnp.asarray(indices), jnp.asarray(indptr), v_,
                shape=(m, k), transpose=transpose)
        return jnp.sum(y * jnp.asarray(ct))

    jw, jv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(v))
    tw = torch.from_numpy(w).requires_grad_(True)
    tv = torch.from_numpy(v).requires_grad_(True)
    y = tfn(tw, *_t(indices, indptr), tv, shape=(m, k), transpose=transpose)
    gw, gv = torch.autograd.grad(y, (tw, tv), torch.from_numpy(ct))
    # the weight gradient is one product per entry: bitwise
    np.testing.assert_array_equal(gw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)


def test_bool_events_get_no_gradient():
    w, indices, indptr, rng = _random_csr(6, 30, 20)
    tw = torch.from_numpy(w).requires_grad_(True)
    s = torch.from_numpy(rng.random(20) < 0.5)
    y = bt.binary_csrmv(tw, *_t(indices, indptr), s, shape=(30, 20))
    (g,) = torch.autograd.grad(y.sum(), tw)
    assert g.shape == tw.shape
    perm = torch.arange(indices.size, dtype=torch.int32)
    y = bt.binary_csrmv_indexed(tw, *_t(indices, indptr), perm, s,
                                shape=(30, 20))
    with pytest.raises(bt.UnsupportedOperationError):
        y.sum().backward()


@pytest.mark.parametrize('op', ['csrmv', 'csrmv_T', 'binary', 'binary_T',
                                'csrmm', 'csrmm_T'])
def test_homogeneous_weight_grad_matches_dense(op):
    """Fault C1 of the JAX package: a ``(1,)`` weight gets the sum, of
    shape ``(1,)``; held against a dense oracle."""
    m, k, B = 70, 50, 3
    _, indices, indptr, rng = _random_csr(7, m, k)
    transpose = op.endswith('_T')
    pattern = _dense_of(np.float32(1.0), indices, indptr, (m, k))
    M = pattern.T if transpose else pattern
    n_in, n_out = M.shape[1], M.shape[0]
    mm = op.startswith('csrmm')
    shape_in = (n_in, B) if mm else (n_in,)
    x = rng.normal(size=shape_in).astype(np.float32)
    ct = rng.normal(size=(n_out, B) if mm else (n_out,)).astype(np.float32)
    fn = {'csrmv': bt.csrmv, 'binary': bt.binary_csrmv,
          'csrmm': bt.csrmm}[op.split('_')[0]]
    w1 = torch.tensor([0.75], requires_grad=True)
    y = fn(w1, *_t(indices, indptr), torch.from_numpy(x), shape=(m, k),
           transpose=transpose)
    (g,) = torch.autograd.grad(y, w1, torch.from_numpy(ct))
    xe = (x > 0).astype(np.float64) if op.startswith('binary') else x
    assert g.shape == (1,)
    np.testing.assert_allclose(g.numpy(), [np.sum(ct * (M @ xe))],
                               rtol=RTOL, atol=ATOL)


def test_class_backward_and_wide_operand_match_dense():
    """``W @ v`` and ``W @ X`` (an operand far wider than the JAX plan
    kernel's VMEM guard, fault C4) differentiate through the class."""
    w, indices, indptr, rng = _random_csr(8, 64, 48)
    D = _dense_of(w, indices, indptr, (64, 48))
    data = torch.from_numpy(w).requires_grad_(True)
    W = bt.CSR((data, *_t(indices, indptr)), shape=(64, 48))
    W.build_weight_indices()
    v = torch.from_numpy(rng.normal(size=48).astype(np.float32))
    v.requires_grad_(True)
    (gv,) = torch.autograd.grad((W @ v).sum(), v)
    np.testing.assert_allclose(gv.numpy(), D.sum(0), rtol=RTOL, atol=ATOL)
    X = torch.from_numpy(rng.normal(size=(48, 3000)).astype(np.float32))
    X.requires_grad_(True)
    Y = W @ X
    np.testing.assert_allclose(Y.detach().numpy(), D @ X.detach().numpy(),
                               rtol=RTOL, atol=1e-4)
    gX, gd = torch.autograd.grad(Y.sum(), (X, data))
    np.testing.assert_allclose(gX.numpy(), np.repeat(
        D.sum(0)[:, None], 3000, 1), rtol=RTOL, atol=ATOL)
    Xn = X.detach().numpy().astype(np.float64)
    np.testing.assert_allclose(gd.numpy(), Xn[indices].sum(1), rtol=RTOL,
                               atol=1e-3)
    Z = torch.from_numpy(rng.normal(size=(2500, 64)).astype(np.float32))
    np.testing.assert_allclose((Z @ W).detach().numpy(), Z.numpy() @ D,
                               rtol=RTOL, atol=1e-4)


# -- the slice -------------------------------------------------------------------

def _jax_csr(kind):
    if kind == 'fromdense':
        rng = np.random.default_rng(11)
        dense = ((rng.random((500, 400)) < 0.05) * rng.random((500, 400))
                 ).astype(np.float32)
        return be.CSR.fromdense(jnp.asarray(dense))
    w, indices, indptr, _ = _random_csr(12, 500, 400, max_per_row=40)
    return be.CSR((jnp.asarray(w), jnp.asarray(indices), jnp.asarray(indptr)),
                  shape=(500, 400))


@pytest.mark.parametrize('kind', ['fromdense', 'random'])
def test_twenty_step_slice_matches_jax(kind):
    J = _jax_csr(kind)
    T = bt.csr_from_arrays(np.asarray(J.data), np.asarray(J.indices),
                           np.asarray(J.indptr), shape=J.shape, device='cpu')
    m, k = J.shape
    rng = np.random.default_rng(13)
    decay = np.float32(0.9)
    X = rng.normal(size=(k, 8)).astype(np.float32)
    Z = rng.normal(size=(8, m)).astype(np.float32)
    jpre, jpost = jnp.zeros(m, jnp.float32), jnp.zeros(k, jnp.float32)
    tpre, tpost = torch.zeros(m), torch.zeros(k)
    for _ in range(20):
        spk, post = rng.random(m) < 0.05, rng.random(k) < 0.05
        pairs = [(be.BinaryArray(jnp.asarray(spk)) @ J,
                  bt.BinaryArray(torch.from_numpy(spk)) @ T),
                 (J @ be.BinaryArray(jnp.asarray(post)),
                  T @ bt.BinaryArray(torch.from_numpy(post)))]
        jpre = jpre * decay + jnp.asarray(spk)
        jpost = jpost * decay + jnp.asarray(post)
        tpre = tpre * float(decay) + torch.from_numpy(spk)
        tpost = tpost * float(decay) + torch.from_numpy(post)
        J = J.update_on_pre(be.BinaryArray(jnp.asarray(spk)), jpost,
                            w_min=0.0, w_max=1.0)
        J = J.update_on_post(jpre, be.BinaryArray(jnp.asarray(post)),
                             w_min=0.0, w_max=1.0)
        T = T.update_on_pre(bt.BinaryArray(torch.from_numpy(spk)), tpost,
                            w_min=0.0, w_max=1.0)
        T = T.update_on_post(tpre, bt.BinaryArray(torch.from_numpy(post)),
                             w_min=0.0, w_max=1.0)
        pairs += [(J @ jnp.asarray(X), T @ torch.from_numpy(X)),
                  (jnp.asarray(Z) @ J, torch.from_numpy(Z) @ T)]
        for want, got in pairs:
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tpre.numpy(), np.asarray(jpre))
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    # the mirror the transposed products cached is the JAX mirror
    J.build_weight_indices()
    for name in ('_t_indptr', '_t_indices', '_t_perm'):
        np.testing.assert_array_equal(getattr(T, name).numpy(),
                                      np.asarray(getattr(J, name)))


def test_csc_from_arrays_and_stdp_match_jax():
    J = _jax_csr('random').tocsc()
    T = bt.csc_from_arrays(np.asarray(J.data), np.asarray(J.indices),
                           np.asarray(J.indptr), shape=J.shape, device='cpu')
    rng = np.random.default_rng(14)
    m, k = J.shape
    spk, trace = rng.random(m) < 0.1, rng.random(k).astype(np.float32)
    J = J.update_on_pre(jnp.asarray(spk), jnp.asarray(trace), 0.0, 1.0)
    T = T.update_on_pre(torch.from_numpy(spk), torch.from_numpy(trace), 0.0,
                        1.0)
    post, ptrace = rng.random(k) < 0.1, rng.random(m).astype(np.float32)
    J = J.update_on_post(jnp.asarray(ptrace), jnp.asarray(post), 0.0, 1.0)
    T = T.update_on_post(torch.from_numpy(ptrace), torch.from_numpy(post),
                         0.0, 1.0)
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    np.testing.assert_allclose(T.todense().numpy(), np.asarray(J.todense()),
                               rtol=0, atol=0)
