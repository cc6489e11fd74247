# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Kernels K1 and K2 against their PyTorch twins on a CUDA device.

Every test here needs a card and skips without one. The file imports no
JAX, so that it also runs where JAX is not installed. ``tests/conftest.py``
imports JAX; on such a host run it without that file::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The bar is bitwise equality: K1 writes the twin's FMAs with
``__fmaf_rn`` and is built with ``-fmad=false``; K2's sums are integers.
"""

import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.models import networks as nw
from brainevent_torch.ops import scatter as sc

pytestmark = pytest.mark.cuda

F32 = np.float32
ORDER = ('v', 't_last', 'g_e', 'g_i', 'counts', 'spike_count', 'ids', 'n_ids')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: K1 and K2 have no CPU form')
    return torch.device('cuda')


@pytest.fixture
def gen():
    return np.random.default_rng(20260816)


def _step_buffers(gen, num, device):
    step = 777
    back = gen.integers(45, 56, num)
    t_last = (np.maximum(step - back, 0).astype(F32) * F32(0.1)).astype(F32)
    t_last[gen.random(num) < 0.2] = F32(-1e7)
    arrays = dict(
        v=gen.uniform(-70.0, -49.0, num).astype(F32), t_last=t_last,
        g_e=gen.uniform(0.0, 3.0, num).astype(F32),
        g_i=gen.uniform(0.0, 20.0, num).astype(F32),
        counts=gen.integers(0, 6, (2, num)).astype(np.int32),
        spike_count=gen.integers(0, 50, num).astype(np.int32),
        ids=np.zeros(num, np.int32), n_ids=np.zeros(2, np.int32))
    return ({k: torch.from_numpy(a).to(device) for k, a in arrays.items()},
            float(F32(step) * F32(0.1)))


@pytest.mark.parametrize('coba', [1, 0], ids=['coba', 'cuba'])
@pytest.mark.parametrize('flags', [(0, 1, 1), (1, 1, 1), (0, 0, 1),
                                   (1, 1, 0)], ids=str)
def test_einet_step_kernel_vs_twin(cuda_device, gen, coba, flags):
    parity, fold, step = flags
    net = bt.EINet(scale=1.0, device=cuda_device)
    p = net.step_params()
    p.coba = coba
    bufs, t = _step_buffers(gen, net.num, cuda_device)
    ref = {k: b.clone() for k, b in bufs.items()}
    before = nw.einet_step.launches
    nw.einet_step(*(bufs[k] for k in ORDER), p, t, parity, fold, step)
    nw.einet_step_twin(*(ref[k] for k in ORDER), p, t, parity, fold, step)
    torch.cuda.synchronize()
    assert nw.einet_step.launches == before + 1
    for k in ('v', 't_last', 'g_e', 'g_i', 'counts', 'spike_count', 'n_ids'):
        assert torch.equal(bufs[k], ref[k]), k
    n = int(ref['n_ids'][parity])
    assert (n > 0) == bool(step)
    assert torch.equal(torch.sort(bufs['ids'][:n]).values, ref['ids'][:n])


@pytest.mark.parametrize('binary', [True, False])
def test_event_scatter_multi_kernel_vs_twin(cuda_device, gen, binary):
    n_out, n_events = 400_000, 800_000
    targets = gen.integers(0, n_out, n_events).astype(np.int32)
    targets[::13] = -1
    shape = (2, n_events)
    values = ((gen.random(shape) < 0.5) if binary
              else gen.normal(size=shape)).astype(np.float32)
    t, v = torch.from_numpy(targets), torch.from_numpy(values)
    want = bt.event_scatter_add_multi(t, v, n_out)
    got = bt.event_scatter_add_multi(t.to(cuda_device), v.to(cuda_device),
                                     n_out)
    torch.cuda.synchronize()
    if binary:              # integer sums: exact at any add order
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    else:                   # float atomics add in arrival order
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('n_act', [0, 17, 40_000])
def test_event_count_scatter_kernel_vs_twin(cuda_device, gen, n_act):
    num, n_conn, n_exc = 40_000, 80, 32_000
    conn = torch.from_numpy(gen.integers(0, num, (num, n_conn))
                            .astype(np.int32))
    ids = torch.from_numpy(gen.permutation(num).astype(np.int32))
    n_ids = torch.tensor([n_act], dtype=torch.int32)
    want = sc.event_count_scatter_twin(
        ids, n_ids, conn, n_exc, torch.zeros(2, num, dtype=torch.int32))
    before = sc.event_count_scatter.launches
    got = sc.event_count_scatter(
        ids.to(cuda_device), n_ids.to(cuda_device), conn.to(cuda_device),
        n_exc, torch.zeros(2, num, dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    assert sc.event_count_scatter.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_run_on_kernels_matches_twin_loop(cuda_device, coba):
    n_steps = 2000
    net = bt.EINet(scale=1.0, coba=coba, device=cuda_device)
    state = net.init_state()
    bt.reset_launch_counts()
    out = bt.einet_pallas_sim(net, state, n_steps)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert counts['einet_step'] == n_steps + 1      # + the final fold
    assert counts['event_count_scatter'] == n_steps
    ref = net._simulate(state, net.times(n_steps), 20.0,
                        step_op=nw.einet_step_twin,
                        scatter_op=sc.event_count_scatter_twin)
    assert torch.equal(out[4], ref.spike_count)
    for got, want in zip(out[:4], (ref.neurons.v, ref.neurons.t_last,
                                   ref.g_e, ref.g_i)):
        assert torch.equal(got, want)
    rate = float(out[4].float().mean()) / (n_steps * net.dt * 1e-3)
    assert 5.0 < rate < 200.0


def test_step_on_card_matches_cpu_step(cuda_device):
    net = bt.EINet(scale=0.25, device=cuda_device)
    cpu = bt.EINet(scale=0.25, conn_all=net.conn_all.cpu())
    s_cpu, s_gpu = cpu.init_state(), net.init_state()
    for t in cpu.times(50):
        s_cpu = cpu.step(s_cpu, t)
        s_gpu = net.step(s_gpu, t)
    torch.cuda.synchronize()
    assert torch.equal(s_gpu.spike_count.cpu(), s_cpu.spike_count)
    assert torch.equal(s_gpu.neurons.v.cpu(), s_cpu.neurons.v)
    assert torch.equal(s_gpu.g_e.cpu(), s_cpu.g_e)
