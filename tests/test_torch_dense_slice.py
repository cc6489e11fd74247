# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The dense slice loop, 20 steps at (300, 200), through the JAX package
and through the port on the CPU, on the same numpy spikes and traces.

Per step: ``BinaryArray(pre) @ W`` and ``W @ BinaryArray(post)``, the
trace decay, ``update_on_pre``/``update_on_post`` clipped to [-1, 1],
``W @ BinaryArray(S)`` with ``S`` (200, 16), and the encoders of ``S``
(``CompactBinary.from_array``, ``binary_2d_csr_encode_p_call``). No
product feeds back into ``W``, so ``W`` is bitwise the JAX one at every
step; the products are within ``1e-5 * sum|W| * gate`` per output; the
encodings are bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import brainevent_torch as bt
import brainevent_tpu as be
from brainevent_tpu import events as je

from _torch_one_thread import one_torch_thread  # noqa: F401

N_PRE, N_POST, B, STEPS, RATE = 300, 200, 16, 20, 0.05


def _close(got, want, bound):
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
    assert got.shape == want.shape
    assert (err <= 1e-5 * bound + 1e-30).all(), err.max()


@pytest.mark.parametrize('kind', ['bool', 'float'])
def test_twenty_step_dense_slice_matches_jax(kind):
    rng = np.random.default_rng(2026)
    w0 = rng.uniform(-1.2, 1.2, (N_PRE, N_POST)).astype(np.float32)
    J = be.Dense(jnp.asarray(w0))
    T = bt.dense_from_arrays(np.asarray(J.data), device='cpu')
    decay = np.float32(0.95)
    jpre, jpost = jnp.zeros(N_PRE, jnp.float32), jnp.zeros(N_POST, jnp.float32)
    tpre, tpost = torch.zeros(N_PRE), torch.zeros(N_POST)
    for _ in range(STEPS):
        pre = rng.random(N_PRE) < RATE
        post = rng.random(N_POST) < RATE
        S = rng.random((N_POST, B)) < RATE
        if kind == 'float':                 # events > 0 for the products
            pre, post = pre.astype(np.float32), post.astype(np.float32)
        w = np.asarray(J.data)
        ja = be.BinaryArray(jnp.asarray(pre)) @ J
        jb = J @ be.BinaryArray(jnp.asarray(post))
        ta = bt.BinaryArray(torch.from_numpy(pre)) @ T
        tb = T @ bt.BinaryArray(torch.from_numpy(post))
        _close(ta, ja, (pre > 0).astype(np.float64) @ np.abs(w))
        _close(tb, jb, np.abs(w) @ (post > 0).astype(np.float64))
        jpre = jpre * decay + jnp.asarray(pre, jnp.float32)
        jpost = jpost * decay + jnp.asarray(post, jnp.float32)
        tpre = tpre * float(decay) + torch.from_numpy(pre).float()
        tpost = tpost * float(decay) + torch.from_numpy(post).float()
        J = J.update_on_pre(be.BinaryArray(jnp.asarray(pre)), jpost, -1.0, 1.0)
        J = J.update_on_post(jpre, be.BinaryArray(jnp.asarray(post)), -1.0,
                             1.0)
        T = T.update_on_pre(bt.BinaryArray(torch.from_numpy(pre)), tpost,
                            -1.0, 1.0)
        T = T.update_on_post(tpre, bt.BinaryArray(torch.from_numpy(post)),
                             -1.0, 1.0)
        np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
        w = np.asarray(J.data)
        jc = J @ be.BinaryArray(jnp.asarray(S))
        tc = T @ bt.BinaryArray(torch.from_numpy(S))
        _close(tc, jc, np.abs(w) @ S.astype(np.float64))
        jcb = be.CompactBinary.from_array(jnp.asarray(S))
        tcb = bt.CompactBinary.from_array(torch.from_numpy(S))
        for got, want in ((tcb.packed, jcb.packed),
                          (tcb.active_ids, jcb.active_ids),
                          (tcb.n_active, jcb.n_active),
                          *zip(bt.binary_2d_csr_encode_p_call(
                              torch.from_numpy(S)),
                              je.binary_2d_csr_encode_p_call(
                                  jnp.asarray(S)))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpre.numpy(), np.asarray(jpre))
    clipped = (np.abs(T.data.numpy()) == 1.0).mean()
    assert 0.0 < clipped < 1.0              # the clip bound some entries
