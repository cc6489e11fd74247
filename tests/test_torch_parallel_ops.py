# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.parallel's sharded ops against brainevent_tpu.parallel's.

The cases of ``tests/test_parallel_ops.py`` at 4 devices: the JAX side on
4 devices of the 8-device virtual CPU mesh (``tests/conftest.py``; a
``(2, 2)`` ``('hosts', 'chips')`` mesh for the 2-D cases), the port's on 4
gloo ranks (``tests/_torch_dist.py``, one spawn for the whole file), on
the same numpy inputs. Tolerances: 0/1 counts scaled by one homogeneous
weight bitwise; float sums (other orders across shards and within them)
``rtol=1e-4, atol=1e-5``, as the gradients; the implicit (JITC) products
``rtol=2e-4, atol=2e-4``, as ``__graft_entry__.py:172-194`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brainevent_tpu import parallel as jpar

import _torch_dist
from _torch_one_thread import one_torch_thread  # noqa: F401

CASES = _torch_dist.ops_cases()


def _jax_case(kind, a, mesh1, mesh2):
    """The JAX package's result of one case, under ``jax.jit`` over the
    weights and the operand (eager ``shard_map`` dispatches op by op, ten
    times slower here); the structure stays concrete for the shard plan."""
    axis = a.get('axis')
    mesh = mesh2 if axis is not None else mesh1
    idx = jnp.asarray(a['indices']) if 'indices' in a else None
    if kind == 'fcn':
        fn = lambda w, x: jpar.sharded_binary_fcnmv(  # noqa: E731
            w, idx, x, mesh=mesh, shape=a['shape'], transpose=a['transpose'],
            axis=axis, reduce=a['reduce'])
    elif kind == 'csr':
        op = {(True, False): jpar.sharded_binary_csrmv,
              (False, False): jpar.sharded_csrmv,
              (True, True): jpar.sharded_binary_csrmm,
              (False, True): jpar.sharded_csrmm}[(a['binary'], a['mm'])]
        plan = jpar.balance_csr_shards(idx, jnp.asarray(a['indptr']), 4,
                                       shape=a['shape'])
        fn = lambda w, x: op(  # noqa: E731
            w, idx, jnp.asarray(a['indptr']), x, mesh=mesh, shape=a['shape'],
            transpose=a['transpose'], reduce=a['reduce'], plan=plan)
    elif kind == 'csr_grad':
        plan = jpar.balance_csr_shards(idx, jnp.asarray(a['indptr']), 4,
                                       shape=a['shape'])

        def loss(w_, x):
            y = jpar.sharded_binary_csrmv(
                w_, idx, jnp.asarray(a['indptr']), x, mesh=mesh,
                shape=a['shape'], axis=axis, plan=plan)
            return jnp.vdot(y, jnp.asarray(a['cot']))
        fn = jax.grad(loss)
    else:
        fn = lambda w, x: jpar.sharded_jitmv(  # noqa: E731
            a['law'], a['params'], 0.1, x, 7, mesh=mesh, shape=a['shape'],
            corder=a['corder'], event=a['event'], transpose=a['transpose'])
    return jax.jit(fn)(jnp.asarray(a.get('w', np.zeros(1, np.float32))),
                       jnp.asarray(a['x']))


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """``(want, got)``: the JAX package's results and the port's, by
    case."""
    mesh1 = jpar.neuron_mesh(4)
    mesh2 = jpar.host_chip_mesh(n_hosts=2, chips_per_host=2)
    want = {name: np.asarray(_jax_case(kind, a, mesh1, mesh2))
            for name, (kind, a) in CASES.items()}
    got = _torch_dist.spawn('ops', 4, tmp_path_factory.mktemp('ops'))
    return want, got


def _exact(kind, a):
    """0/1 hits scaled once by a homogeneous weight: exact in both."""
    return kind in ('fcn', 'csr') and a['w'].shape == (1,) and (
        kind == 'fcn' or a['binary'])


@pytest.mark.parametrize('name', sorted(CASES))
def test_sharded_op_matches_jax(results, name):
    want, got = results
    kind, a = CASES[name]
    assert got[name].shape == want[name].shape, name
    if _exact(kind, a):
        np.testing.assert_array_equal(got[name], want[name])
    elif kind == 'jit':
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=2e-4)
    else:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5)


def test_psum_scatter_divisibility_guard(results):
    assert bool(results[1]['guard_psum_scatter'])


def test_fcn_backward_raises_like_single_device(results):
    # binary_fcnmv has no backward in the port (fcn/float.py is not
    # ported); the sharded op raises the same error
    assert bool(results[1]['fcn_backward_raises'])


def test_cases_cover_every_port_wrapper():
    kinds = {kind for kind, _ in CASES.values()}
    assert kinds == {'fcn', 'csr', 'csr_grad', 'jit'}
    assert {(a['binary'], a['mm']) for kind, a in CASES.values()
            if kind == 'csr'} == {(True, False), (False, False),
                                  (True, True), (False, True)}
    assert {a['law'] for kind, a in CASES.values() if kind == 'jit'} == {
        's', 'n', 'u'}
