# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The JITC families of brainevent_torch (twins of K12-K14) against
brainevent_tpu on the CPU.

- ``todense`` (``jits``/``jitn``/``jitu``) in both modes and both
  ``corder``, against the JAX engine (``jax_raw``), and in four of those
  cases (every law, mode and order among them) against the interpreted
  Pallas kernels (``jitc_todense_pallas(_mm)``): scalar and uniform
  bitwise; normal with the zero pattern bitwise and each weight within 2
  spacings of ``max(|w|, |w_loc|)`` (the measured worst case over all
  2^24 uniforms at ``(0.6, 0.06)`` and ``(6.7, 0.67)``, JITCNet's laws; the
  difference is XLA's float32 ``log`` in the tails).
- the products (``jit*mv``, ``jit*mm`` at B in {1, 8, 33}, ``binary_jit*``
  with bool and float events, both directions) within
  ``1e-5 * sum|w x|`` per output, the bound taken from the port's own
  dense matrix. Each JAX call compiles, so a product test takes one
  operand kind, in turn: every kind meets every law and every walk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_tpu.jitc as J
import brainevent_torch as bt
import brainevent_torch.jitc as T

from _torch_one_thread import one_torch_thread  # noqa: F401

PROB = 0.1
SEED = 123
SHAPES = [(300, 200), (257, 1000), (64, 4000)]
# law: (tag, weight params); the normal and uniform params are JITCNet's
LAWS = {'scalar': ('s', (0.6,)), 'normal': ('n', (0.6, 0.06)),
        'uniform': ('u', (0.48, 0.72))}


def _jax_dense(law, shape, corder, mode, backend, transpose=False):
    tag, params = LAWS[law]
    return np.asarray(getattr(J, f'jit{tag}')(
        *params, PROB, SEED, shape=shape, transpose=transpose, corder=corder,
        matrix_mode=mode, backend=backend))


def _port_dense(law, shape, corder, mode, transpose=False):
    tag, params = LAWS[law]
    return getattr(bt, f'jit{tag}')(
        *params, PROB, SEED, shape=shape, transpose=transpose, corder=corder,
        matrix_mode=mode, device='cpu').numpy()


def assert_dense_equal(law, got, want, loc=None):
    """Scalar and uniform bitwise; normal: zero pattern bitwise, values
    within 2 spacings of max(|w|, |loc|)."""
    if law != 'normal':
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got != 0, want != 0)
    loc = abs(np.float32(LAWS['normal'][1][0] if loc is None else loc))
    spacing = np.spacing(np.maximum(np.abs(want), loc))
    assert (np.abs(got - want) <= 2 * spacing).all()


@pytest.mark.parametrize('mode', ['mv', 'mm'])
@pytest.mark.parametrize('corder', [True, False], ids=['corder', 'rorder'])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('law', list(LAWS))
def test_todense_matches_jax_engine(law, shape, corder, mode):
    got = _port_dense(law, shape, corder, mode)
    want = _jax_dense(law, shape, corder, mode, 'jax_raw')
    assert got.shape == shape
    assert 0.05 < (got != 0).mean() < 0.2
    assert_dense_equal(law, got, want)


@pytest.mark.parametrize('law, corder, mode', [
    ('scalar', True, 'mv'), ('normal', False, 'mv'),
    ('uniform', True, 'mm'), ('normal', False, 'mm')],
    ids=['scalar-corder-mv', 'normal-rorder-mv', 'uniform-corder-mm',
         'normal-rorder-mm'])
def test_todense_matches_interpreted_pallas(law, corder, mode):
    shape = (257, 1000)
    got = _port_dense(law, shape, corder, mode)
    assert_dense_equal(law, got, _jax_dense(law, shape, corder, mode,
                                            'pallas'))


@pytest.mark.parametrize('law', list(LAWS))
def test_transposed_todense_chunks_on_the_other_axis(law):
    # transpose=True materializes (shape[1], shape[0]), chunked on shape[0]
    got = _port_dense(law, (64, 401), True, 'mv', transpose=True)
    want = _jax_dense(law, (64, 401), True, 'mv', 'jax_raw', transpose=True)
    assert got.shape == (401, 64)
    assert_dense_equal(law, got, want)


def _bound_ok(got, want, bound, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert (np.abs(got - want) <= 1e-5 * bound + 1e-6).all(), (
        what, np.abs(got - want).max())


def _operand(rng, n, kind, batch=None):
    shape = (n,) if batch is None else (n, batch)
    if kind == 'bool':
        return rng.random(shape) < 0.3
    if kind == 'events':      # float events: > 0 is a spike
        on = rng.random(shape) < 0.3
        return np.where(on, 1.0, -0.5 * rng.random(shape)).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _abs_dense(law, shape, corder, mode, transpose):
    # |M| (or |M.T|) in the product's orientation
    d = np.abs(_port_dense(law, shape, corder, mode))
    return d.T if transpose else d


def _gate(x, event):
    if x.dtype == bool:
        return x.astype(np.float32)
    return (x > 0).astype(np.float32) if event else np.abs(x)


# (operand kind, event)
KINDS = [('normal', False), ('bool', True), ('events', True)]

PRODUCT_CASES = [
    # (shape, transpose, corder)
    ((300, 200), False, True), ((300, 200), True, False),
    ((257, 1000), False, False), ((257, 1000), True, True),
    ((64, 4000), False, True), ((64, 4000), True, False),
]


@pytest.mark.parametrize('case', PRODUCT_CASES,
                         ids=lambda c: f'{c[0][0]}x{c[0][1]}-'
                                       f'{"T" if c[1] else "NT"}-'
                                       f'{"c" if c[2] else "r"}')
@pytest.mark.parametrize('law', list(LAWS))
def test_mv_matches_jax(law, case):
    shape, transpose, corder = case
    tag, params = LAWS[law]
    i = list(LAWS).index(law) + PRODUCT_CASES.index(case)
    rng = np.random.default_rng(10 * list(LAWS).index(law)
                                + PRODUCT_CASES.index(case))
    in_len = shape[0] if transpose else shape[1]
    bound_m = _abs_dense(law, shape, corder, 'mv', transpose)
    kind, event = KINDS[i % len(KINDS)]
    x = _operand(rng, in_len, kind)
    name = f'{"binary_" if event else ""}jit{tag}mv'
    want = getattr(J, name)(*params, PROB, jnp.asarray(x), SEED,
                            shape=shape, transpose=transpose,
                            corder=corder, backend='jax_raw')
    got = getattr(bt, name)(*params, PROB, torch.from_numpy(x), SEED,
                            shape=shape, transpose=transpose, corder=corder)
    _bound_ok(got, want, bound_m @ _gate(x, event), (name, kind))


# the first four product cases spread over the batch widths, two each
# (every case and both walk directions appear; each JAX call compiles)
MM_CASES = {1: (1, 3), 8: (0, 2), 33: (1, 2)}


@pytest.mark.parametrize('batch', list(MM_CASES))
@pytest.mark.parametrize('law', list(LAWS))
def test_mm_matches_jax(law, batch):
    tag, params = LAWS[law]
    rng = np.random.default_rng(batch)
    for j, i in enumerate(MM_CASES[batch]):
        shape, transpose, corder = PRODUCT_CASES[i]
        in_len = shape[0] if transpose else shape[1]
        bound_m = _abs_dense(law, shape, corder, 'mm', transpose)
        # float and bool operands in turn
        kind, event = KINDS[(list(LAWS).index(law) + j) % 2]
        B = _operand(rng, in_len, kind, batch)
        name = f'{"binary_" if event else ""}jit{tag}mm'
        want = getattr(J, name)(*params, PROB, jnp.asarray(B), SEED,
                                shape=shape, transpose=transpose,
                                corder=corder, backend='jax_raw')
        got = getattr(bt, name)(*params, PROB, torch.from_numpy(B), SEED,
                                shape=shape, transpose=transpose,
                                corder=corder)
        _bound_ok(got, want, bound_m @ _gate(B, event),
                  (name, shape, transpose, corder))


@pytest.mark.parametrize('law', list(LAWS))
def test_mm_in_mv_mode_samples_the_mv_matrix(law):
    tag, params = LAWS[law]
    rng = np.random.default_rng(5)
    B = _operand(rng, 200, 'events', 8)
    want = getattr(J, f'binary_jit{tag}mm')(
        *params, PROB, jnp.asarray(B), SEED, shape=(300, 200), corder=True,
        matrix_mode='mv', backend='pallas')
    got = getattr(bt, f'binary_jit{tag}mm')(
        *params, PROB, torch.from_numpy(B), SEED, shape=(300, 200),
        corder=True, matrix_mode='mv')
    bound = np.abs(_port_dense(law, (300, 200), True, 'mv')) @ _gate(B, True)
    _bound_ok(got, want, bound, 'mm mv-mode')


def test_zero_prob_gives_zeros():
    x = torch.ones(200)
    assert torch.equal(bt.jitsmv(0.5, 0.0, x, SEED, shape=(300, 200)),
                       torch.zeros(300))
    assert torch.equal(bt.jits(0.5, 0.0, SEED, shape=(3, 4), device='cpu'),
                       torch.zeros(3, 4))


def test_backward_through_a_product_raises():
    v = torch.randn(200, requires_grad=True)
    y = bt.jitnmv(0.6, 0.06, PROB, v, SEED, shape=(300, 200))
    with pytest.raises(bt.UnsupportedOperationError, match='gradient'):
        y.sum().backward()
    w = torch.tensor(0.5, requires_grad=True)
    y = bt.jitsmv(w, PROB, torch.randn(200), SEED, shape=(300, 200))
    with pytest.raises(bt.UnsupportedOperationError):
        y.sum().backward()
    M = T.JITCScalarR((0.5, PROB, SEED), shape=(300, 200), device='cpu')
    v = torch.randn(300, requires_grad=True)
    with pytest.raises(bt.UnsupportedOperationError):
        (v @ M).sum().backward()


def test_operand_length_is_checked():
    with pytest.raises(ValueError, match='operand length'):
        bt.jitsmv(0.5, PROB, torch.ones(7), SEED, shape=(300, 200))


# -- K12's event scatter: the edge cases of the active-row walk --------------------

def _spikes(rng, n, rate, kind):
    on = (np.ones(n, bool) if rate == 1.0 else rng.random(n) < rate)
    if kind == 'bool':
        return on
    return np.where(on, 1.0, -0.5 * rng.random(n)).astype(np.float32)


@pytest.mark.parametrize('kind', ['bool', 'events'])
@pytest.mark.parametrize('rate', [0.0, 0.01, 1.0], ids=['none', '1%', 'all'])
@pytest.mark.parametrize('shape', [(200, 1000), (1000, 1000)],
                         ids=['1chunk', '4chunks'])
@pytest.mark.parametrize('law', ['scalar', 'normal'])
def test_event_scatter_edge_cases_match_jax(law, shape, rate, kind):
    """The event scatter (``corder=False``) over 1000 walk rows (not a
    multiple of 32), one chunk (200 walk columns of a 250-wide chunk) and
    four, no, 1% and every row spiking: within 1e-5 * sum|w x| of the JAX
    event product; no spikes give exact zeros."""
    tag, params = LAWS[law]
    rng = np.random.default_rng(shape[0] + int(100 * rate))
    x = _spikes(rng, shape[1], rate, kind)
    name = f'binary_jit{tag}mv'
    want = getattr(J, name)(*params, PROB, jnp.asarray(x), SEED, shape=shape,
                            corder=False, backend='jax_raw')
    got = getattr(bt, name)(*params, PROB, torch.from_numpy(x), SEED,
                            shape=shape, corder=False)
    if rate == 0.0:
        assert not got.any()
    bound = _abs_dense(law, shape, False, 'mv', False) @ _gate(x, True)
    _bound_ok(got, want, bound, (name, shape, rate, kind))


@pytest.mark.parametrize('kind', ['bool', 'events'])
@pytest.mark.parametrize('law', ['scalar', 'normal'])
def test_event_scatter_row0_halves_match_jax(law, kind):
    """Two halves of the walk rows, each from its own ``row0`` (the
    sharded ops' split), against the JAX engine's walk of the same
    halves, and their sum against the whole walk."""
    from brainevent_tpu.jitc import engine as je
    from brainevent_tpu.jitc.normal import _normal_weight
    from brainevent_torch._misc import _initialize_conn_length
    from brainevent_torch.jitc import pallas_kernels as jk
    code, (a, b) = (0, (0.5, 0.0)) if law == 'scalar' else (1, (0.6, 0.06))
    a, b = float(np.float32(a)), float(np.float32(b))
    n_rows, n_cols, half = 1000, 700, 500
    cl = _initialize_conn_length(PROB)
    rng = np.random.default_rng(11)
    x = _spikes(rng, n_rows, 0.05, kind)

    def jweight(seed, rows, cols):
        if code == 0:
            return jnp.full(rows.shape, a, jnp.float32)
        return _normal_weight((jnp.array([a], jnp.float32),
                               jnp.array([b], jnp.float32)), seed, rows, cols)

    kw = dict(law=code, a=a, b=b, seed=SEED, cl=cl, n_cols=n_cols,
              logical_cols=n_cols, corder=False, event=True)
    parts = []
    for r0 in (0, half):
        xi = torch.from_numpy(x[r0:r0 + half])
        got = jk.jitc_walk_mv(None, None, xi, n_rows=half, row0=r0, **kw)
        want = je.walk_matvec(jweight, SEED, cl, jnp.asarray(x[r0:r0 + half]),
                              n_cols, corder=False, logical_cols=n_cols,
                              event=True, row0=r0)
        bound = jk.jitc_walk_mv(None, None, xi, n_rows=half, row0=r0,
                                **dict(kw, law=0, a=a + 6 * b, b=0.0))
        _bound_ok(got, want, bound.numpy(), ('half', r0))
        parts.append(got)
    whole = jk.jitc_walk_mv(None, None, torch.from_numpy(x), n_rows=n_rows,
                            **kw)
    bound = jk.jitc_walk_mv(None, None, torch.from_numpy(x), n_rows=n_rows,
                            **dict(kw, law=0, a=a + 6 * b, b=0.0))
    _bound_ok(parts[0] + parts[1], whole, bound.numpy(), 'halves sum')
