# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.models.neurons against brainevent_tpu.models.neurons.

Inputs are made with numpy from a seed and given to both packages. The
LIF update is compared bit for bit: ``jax.jit`` on the CPU contracts
``v + X * (dt/tau)`` into one FMA, and the port writes that FMA out as
``torch.addcmul``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brainevent_tpu.models import neurons as jn
from brainevent_torch.models import neurons as tn

from _torch_one_thread import one_torch_thread  # noqa: F401

F32 = np.float32


def _states(n, step, seed):
    """*n* states around the refractory boundary at time
    ``float32(step) * float32(0.1)``: t_last lies within a few steps of
    ``t - tau_ref`` (both sides, and exactly on it), or long ago."""
    rng = np.random.default_rng(seed)
    t = F32(step) * F32(0.1)
    back = rng.integers(45, 56, n)                       # steps since spike
    t_last = (np.maximum(step - back, 0).astype(F32) * F32(0.1)).astype(F32)
    t_last[rng.random(n) < 0.2] = F32(-1e7)
    v = rng.uniform(-75.0, -45.0, n).astype(F32)
    current = rng.uniform(-60.0, 120.0, n).astype(F32)
    return t, v, t_last, current


@pytest.mark.parametrize('step', [50, 1234, 99_999])
def test_lifref_step_bitwise_vs_jax(step):
    t, v, t_last, current = _states(1_000_000, step, seed=step)
    p_j, p_t = jn.LIFRefParams(), tn.LIFRefParams()
    f = jax.jit(lambda v, tl, c, t: jn.lifref_step(
        jn.LIFRefState(v=v, t_last=tl), c, t, 0.1, p_j))
    js, jspk = f(v, t_last, current, jnp.float32(t))
    ts, tspk = tn.lifref_step(
        tn.LIFRefState(v=torch.from_numpy(v), t_last=torch.from_numpy(t_last)),
        torch.from_numpy(current), float(t), 0.1, p_t)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    np.testing.assert_array_equal(ts.v.numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(ts.t_last.numpy(), np.asarray(js.t_last))
    # the sample straddles the boundary: some held, some spiking
    refractory = (t - t_last) < F32(5.0)
    assert 0 < refractory.sum() < len(v)
    assert 0 < tspk.sum() < len(v)


def test_resting_stays_at_rest():
    p = tn.LIFRefParams()
    st = tn.LIFRefState(v=torch.full((4,), p.v_rest),
                        t_last=torch.full((4,), -1e7))
    st2, spk = tn.lifref_step(st, torch.zeros(4), 0.0, 0.1, p)
    assert not bool(spk.any())
    np.testing.assert_allclose(st2.v.numpy(), p.v_rest, atol=1e-6)


def test_strong_input_spikes_and_resets():
    p = tn.LIFRefParams()
    st = tn.LIFRefState(v=torch.full((2,), -50.5),
                        t_last=torch.full((2,), -1e7))
    st2, spk = tn.lifref_step(st, torch.full((2,), 1000.0), 1.0, 0.1, p)
    assert bool(spk.all())
    np.testing.assert_allclose(st2.v.numpy(), p.v_reset)
    np.testing.assert_allclose(st2.t_last.numpy(), 1.0)


def test_refractory_blocks_integration():
    p = tn.LIFRefParams()
    st = tn.LIFRefState(v=torch.full((1,), p.v_reset), t_last=torch.zeros(1))
    st2, spk = tn.lifref_step(st, torch.full((1,), 1000.0), 1.0, 0.1, p)
    assert not bool(spk.any())
    np.testing.assert_allclose(st2.v.numpy(), p.v_reset)


def test_lifref_init_draws_from_generator():
    p = tn.LIFRefParams()
    a = tn.lifref_init(torch.Generator().manual_seed(3), 10_000, p,
                       device='cpu')
    b = tn.lifref_init(torch.Generator().manual_seed(3), 10_000, p,
                       device='cpu')
    np.testing.assert_array_equal(a.v.numpy(), b.v.numpy())
    assert a.v.dtype == torch.float32 and a.v.shape == (10_000,)
    assert abs(float(a.v.mean()) + 55.0) < 0.1
    assert abs(float(a.v.std()) - 2.0) < 0.1
    assert (a.t_last.numpy() == F32(-1e7)).all()


def test_surrogate_spike_forward_and_grad_vs_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 1.5, 4096).astype(F32)
    x[:3] = (-1.0, 0.0, 1.0)
    w = rng.normal(size=4096).astype(F32)
    jy = jn.surrogate_spike(jnp.asarray(x))
    jg = jax.grad(lambda a: jnp.sum(jn.surrogate_spike(a) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tn.surrogate_spike(tx)
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ty.detach().numpy()[:3], [0.0, 1.0, 1.0])
