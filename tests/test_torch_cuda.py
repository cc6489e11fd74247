# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Kernels K1-K22 against their PyTorch twins on a CUDA device, and the
port's slices and routes through them at the sizes of its main paths.

Every test here needs a card and skips without one. The file imports no
JAX, so that it also runs where JAX is not installed. ``tests/conftest.py``
imports JAX; on such a host run it without that file::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

K1 and K2 are held to bitwise equality: K1 writes the twin's FMAs with
``__fmaf_rn`` and is built with ``-fmad=false``; K2's sums are integers.
K2's float64 instance sums within ``1e-12 * sum|v|`` of the float64 twin,
its integer instances bitwise (C13, C14). K21 (the whole EI run in one
launch) is bitwise the twin loop and the K1 + K2 loop in all five outputs:
COBA and CUBA at 4k, 40k and 400k over 2,000 steps, 0-2 steps, an
all-fire burst, each NPT instance, each run twice (a stale L1 line would
show only sometimes); above its capacity ``EINet.run`` runs K1 + K2.
K21's cluster instance (the default where one cluster holds the network,
4k among them) bitwise the twin and the grid instance forced at NPT 1:
COBA and CUBA at 4k, a burst, 1 and 33 neurons, the capacity's edge, few
targets (NPT 2 and 4), 0-301 steps, two runs chained, targets outside
``[0, num)``; the ``run`` span's route by size.
K3/K4 (gather plans) sum each row in another order than the twin's
``index_add_``: ``|y - twin| <= 1e-5 * sum|w x|`` per row, K3's ``y``
bitwise K4's (with and without the row view), and K4's ``dw`` (one
product per slot) bitwise, 0 at padding. K5/K6 (``binary_fcnmv``): homogeneous
weights exact; heterogeneous K5 (float atomics) within ``1e-5 * sum|w|``
per target, K6 within ``1e-6 * sum|w|`` per row. K7-K10 (the CSR slice):
homogeneous binary products exact (int32 counts, scaled once); the others
within ``1e-5 * sum|w op(x)|`` per output, K7 and K10 bitwise on a repeat
(no atomics), K10 bitwise its stored-order sum ``csr_gather_mm_ordered``
at widths 1-300, aligned and offset operands, float32 and float64; K9
bitwise (one rounding). K11-K14 (the JITC walk): the
stream setup and the dense matrix bitwise (the kernels compute the twin's
float32 operations, with its FMAs and its float64 ``log``); the products
within ``1e-5 * sum|w x|`` per output, the gathers bitwise on a repeat;
K12's event scatter at 0-100% spiking, 1-64,000 walk rows, with a row
offset, over a plan and drawing its own setup.
K15/K16 (the dense event products) within ``1e-5 * sum|W| * gate`` per
output and bitwise on a repeat, K15's ``s @ W`` (at k up to 70,000, float64
too) and K16 bitwise the ascending-index loop; K17 (dense STDP) bitwise (one
rounding, the gate being 0 or 1); K18 (the row count) exact; K19 (the dense EI
propagation) exact and bitwise K2's counts, K21's table instance (the dense
strategy in one launch) bitwise the K1 + K19 loop at 4k and 40k over 2,000
steps, each NPT instance, int32 tables and rows whose bytes are not a
multiple of 16, and every strategy of ``einet_pallas_sim`` bitwise the
mxu3 route over 2,000 steps. The public
entries (``tests/_torch_card.py``'s matrix): spikes of nine dtypes
bitwise the bool spikes' result through the kernel; float16 and bfloat16
weights within 1 ulp of the twin on the widened weights, plus the float32
bound; float64 weights through the kernels' ``double`` instances (C10),
one launch each, within ``1e-12 * sum|w x|`` of the float64 twin (bitwise
where the route is exact). K20 (the sharded mega-scatter) exact against
its twin, its four shards summed bitwise K2; K22 (the sharded step in one
launch) bitwise its twin and one K1 step, a memset and K20 at 4k and 400k,
at world size 1 and over four shards; K11/K12 with a row offset
(``row0``) bitwise the whole walk's rows (gather) and within the float32
atomic-order bound (scatter); ``ShardedEINet`` and the sharded ops at world
size 1 under NCCL bitwise the single-device routes.
"""

import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch.fcn import binary as fb
from brainevent_torch.models import networks as nw
from brainevent_torch.models import training as tr
from brainevent_torch.ops import mxu_gather as mg
from brainevent_torch.ops import scatter as sc

import _torch_card as card
from _torch_dist import CollectiveLog

pytestmark = pytest.mark.cuda

F32 = np.float32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU form')
    return torch.device('cuda')


@pytest.fixture
def gen():
    return np.random.default_rng(20260816)


@pytest.mark.parametrize('scale', [1.0, 100.0], ids=['4k', '400k'])
@pytest.mark.parametrize('coba', [1, 0], ids=['coba', 'cuba'])
@pytest.mark.parametrize('flags', [(0, 1, 1), (1, 1, 1), (0, 0, 1),
                                   (1, 1, 0)], ids=str)
def test_einet_step_kernel_vs_twin(cuda_device, gen, coba, flags, scale):
    parity, fold, step = flags
    net = bt.EINet(scale=scale, device=cuda_device)
    p = net.step_params()
    p.coba = coba
    bufs, t = card.step_buffers(gen, net.num, cuda_device)
    ref = {k: b.clone() for k, b in bufs.items()}
    before = nw.einet_step.launches
    nw.einet_step(*(bufs[k] for k in card.ORDER), p, t, parity, fold, step)
    nw.einet_step_twin(*(ref[k] for k in card.ORDER), p, t, parity, fold,
                       step)
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


@pytest.mark.parametrize('share', [0, 17, 0.01, 1.0],
                         ids=['0', '17', '1%', 'all'])
@pytest.mark.parametrize('num', [40_000, 400_000], ids=['40k', '400k'])
def test_event_count_scatter_kernel_vs_twin(cuda_device, gen, num, share):
    """K2 equal to its twin, and its float form on the same events (each
    spike's targets with 0/1 values in its class's channel) equal to
    both: the sums are integers, exact in any order."""
    n_conn, n_exc = 80, int(0.8 * num)
    n_act = share if isinstance(share, int) else int(share * num)
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
    sel = ids[:n_act].long()
    is_exc = (sel < n_exc).float()
    values = torch.stack([is_exc, 1 - is_exc])[:, :, None].expand(
        2, n_act, n_conn).reshape(2, -1).contiguous()
    out = sc.event_scatter_float(
        conn[sel].reshape(-1).to(cuda_device), values.to(cuda_device),
        torch.zeros(2, num, device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want.float())


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_run_on_kernels_matches_twin_loop(cuda_device, coba):
    n_steps = 2000
    net = bt.EINet(scale=1.0, coba=coba, device=cuda_device)
    state = net.init_state()
    bt.reset_launch_counts()
    out = bt.einet_pallas_sim(net, state, n_steps)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert counts['einet_sim'] == 1                 # the whole run, K21
    assert counts['einet_step'] == counts['event_count_scatter'] == 0
    ref = net._simulate(state, net.times(n_steps), 20.0,
                        step_op=nw.einet_step_twin,
                        scatter_op=sc.event_count_scatter_twin)
    assert torch.equal(out[4], ref.spike_count)
    for got, want in zip(out[:4], (ref.neurons.v, ref.neurons.t_last,
                                   ref.g_e, ref.g_i)):
        assert torch.equal(got, want)
    rate = float(out[4].float().mean()) / (n_steps * net.dt * 1e-3)
    assert 5.0 < rate < 200.0


_fields = card.fields


def _k21(net, state, n, inp=20.0, **kw):
    """One launch of K21 over *n* steps from *state* (a copy), with the
    instance and grid of *kw*."""
    bufs = [x.clone() for x in _fields(state)]
    times = torch.tensor(net.times(n), dtype=torch.float32,
                         device=bufs[0].device)
    before = nw.einet_sim.launches
    nw.einet_sim.cuda(nw.einet_sim, *bufs, net.conn_all, times,
                      net.step_params(inp), net.n_exc, **kw)
    torch.cuda.synchronize()
    assert nw.einet_sim.launches == before + 1
    return bufs


def _loops(net, state, n, inp=20.0):
    """The twin loop and the K1 + K2 loop on the card from *state*."""
    twin = net._simulate(state, net.times(n), inp, **card.twin_ops())
    k12 = net._simulate(state, net.times(n), inp, **card.k1k2_ops())
    torch.cuda.synchronize()
    return _fields(twin), _fields(k12)


def _bitwise(got, want):
    for name, x, y in zip(('v', 't_last', 'g_e', 'g_i', 'spike_count'), got,
                          want):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize('scale', [1.0, 10.0, 100.0],
                         ids=['4k', '40k', '400k'])
@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_k21_bitwise_twin_and_k1k2_loops(cuda_device, coba, scale):
    """K21 through EINet.run, twice (a stale L1 line would show only
    sometimes), against the twin loop and the K1 + K2 loop: all five
    outputs bitwise over 2,000 steps; COBA fires at 5-200 Hz."""
    net = bt.EINet(scale=scale, coba=coba, device=cuda_device)
    state = net.init_state()
    twin, k12 = _loops(net, state, 2000)
    for _ in range(2):
        bt.reset_launch_counts()
        out = _fields(net.run(2000, state=state))
        torch.cuda.synchronize()
        assert bt.launch_counts()['einet_sim'] == 1
        _bitwise(out, twin)
        _bitwise(out, k12)
    rate = float(out[4].float().mean()) / (2000 * net.dt * 1e-3)
    assert not coba or 5.0 < rate < 200.0


@pytest.mark.parametrize('n', [0, 1, 2])
@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_k21_few_steps(cuda_device, coba, n):
    net = bt.EINet(scale=1.0, coba=coba, device=cuda_device)
    state = net.run(300)
    twin, k12 = _loops(net, state, n)
    out = _k21(net, state, n)
    _bitwise(out, twin)
    _bitwise(out, k12)
    if n == 0:
        _bitwise(out, _fields(state))


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_k21_all_fire_burst(cuda_device, coba):
    """Every neuron above threshold and none refractory, inp 500: all fire
    at the first step (4,000 rows of 80 atomics in one step), and often
    after."""
    net = bt.EINet(scale=1.0, coba=coba, seed=3, device=cuda_device)
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, device=cuda_device)
    state = s._replace(neurons=s.neurons._replace(
        v=v, t_last=torch.full_like(v, -1e7)))
    twin, k12 = _loops(net, state, 200, 500.0)
    for _ in range(2):
        out = _k21(net, state, 200, 500.0)
        _bitwise(out, twin)
        _bitwise(out, k12)
    first = _k21(net, state, 1, 500.0)
    assert int(first[4].min()) == 1


@pytest.mark.parametrize('npt', [1, 2, 4, 8])
@pytest.mark.parametrize('scale', [1.0, 10.0], ids=['4k', '40k'])
def test_k21_each_instance(cuda_device, scale, npt):
    """Each NPT instance (the NPT = 8 one only through the launch's
    instance argument at these sizes), twice, bitwise the loops."""
    net = bt.EINet(scale=scale, device=cuda_device)
    state = net.init_state()
    twin, k12 = _loops(net, state, 2000)
    for _ in range(2):
        out = _k21(net, state, 2000, npt=npt)
        _bitwise(out, twin)
        _bitwise(out, k12)


def test_k21_grid_and_instance(cuda_device):
    """The package's choice: the fewest neurons a thread whose grid fits,
    16 blocks of 256 at 4k; a larger grid of the same instance and its
    most co-resident blocks give the same bits; one more is refused."""
    net = bt.EINet(scale=1.0, device=cuda_device)
    assert nw.einet_sim_grid(net.num, cuda_device) == (1, 16)
    most = nw.einet_sim_max_blocks(cuda_device, 1)
    state = net.init_state()
    want = _k21(net, state, 500)
    _bitwise(_k21(net, state, 500, npt=1, blocks=most), want)
    before = nw.einet_sim.launches
    with pytest.raises(bt.KernelExecutionError, match='cooperative'):
        _k21(net, state, 5, npt=1, blocks=most + 1)
    assert nw.einet_sim.launches == before
    _bitwise(_k21(net, state, 500), want)           # the card still runs


def test_k21_capacity_routes_by_size(cuda_device):
    """Above K21's capacity EINet.run keeps the loop of K1 and K2 (2n + 1
    launches, no K21), bitwise the twin loop over 2,000 steps; at the
    capacity's edge it runs K21."""
    cap = nw.einet_sim_capacity(cuda_device)
    assert cap == nw.einet_sim_max_blocks(cuda_device, 8) * 256 * 8
    net = bt.EINet(scale=float(cap // 4000 + 1), device=cuda_device)
    assert net.num > cap
    state = net.init_state()
    bt.reset_launch_counts()
    out = _fields(net.run(2000, state=state))
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert (counts['einet_sim'], counts['einet_step'],
            counts['event_count_scatter']) == (0, 2001, 2000)
    twin, _ = _loops(net, state, 2000)
    _bitwise(out, twin)
    with pytest.raises(ValueError, match='exceed'):
        nw.einet_sim_grid(net.num, cuda_device)
    small = bt.EINet(scale=float(cap // 4000), device=cuda_device)
    bt.reset_launch_counts()
    small.run(5)
    assert bt.launch_counts()['einet_sim'] == 1


def _cluster_net(device, num, n_conn=80, coba=True, seed=5):
    """``(p, n_exc, conn, state)``: EINet's scale-1 parameters on *num*
    neurons (80% excitatory), *n_conn* targets a neuron drawn in ``[0,
    num)`` and an initial state drawn as ``EINet`` draws one."""
    net = bt.EINet(scale=1.0, coba=coba, device=device)
    gen = torch.Generator().manual_seed(seed)
    conn = torch.randint(0, num, (num, n_conn), generator=gen,
                         dtype=torch.int32).to(device)
    neurons = bt.lifref_init(gen, num, net.params, device=device)
    zeros = torch.zeros(num, device=device)
    p = net.step_params()
    p.num = num
    return p, int(0.8 * num), conn, [
        neurons.v, neurons.t_last, zeros, zeros.clone(),
        torch.zeros(num, dtype=torch.int32, device=device)]


def _times(n, device, start=0):
    """The step times ``float32(i) * float32(0.1)``, ``start <= i < start +
    n``, as EINet.times makes them."""
    return torch.from_numpy(np.arange(start, start + n, dtype=F32)
                            * F32(0.1)).to(device)


def _cluster_runs(p, n_exc, conn, state, times):
    """K21 by default (asserted to be its cluster instance), K21's grid
    instance at NPT 1 on at least 16 blocks, and the twin, from copies of
    *state* at the step *times*."""
    device = conn.device
    num, n_conn = conn.shape
    assert nw.einet_sim_cluster(num, n_conn, device) is not None
    runs = []
    for kw in ({}, dict(npt=1, blocks=max(16, -(-num // 256))), None):
        bufs = [x.clone() for x in state]
        if kw is None:
            nw.einet_sim_twin(*bufs, conn, times, p, n_exc)
        else:
            nw.einet_sim.cuda(nw.einet_sim, *bufs, conn, times, p, n_exc,
                              **kw)
        runs.append(bufs)
    torch.cuda.synchronize()
    return runs


def _cluster_edge(device, n_conn):
    """The most neurons of *n_conn* targets K21's cluster instance holds
    on *device*: its largest cluster times the neurons a block holds."""
    most, smem = nw._cluster_limits(device.index or 0)
    share = min(smem // (4 * (n_conn + 4)),
                nw.SIM_CLUSTER_THREADS * nw.SIM_CLUSTER_NPT[-1])
    return most * share


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_k21_cluster_4k_bitwise_twin_and_grid(cuda_device, coba):
    """At Brette's 4,000 neurons K21 runs its cluster instance (8 blocks
    of 500 on an H100), twice, bitwise the twin and the grid instance
    forced at NPT 1 on 16 blocks over 2,000 steps."""
    net = bt.EINet(scale=1.0, coba=coba, device=cuda_device)
    assert nw.einet_sim_cluster(net.num, 80, cuda_device) == (8, 500, 1)
    state = net.init_state()
    times = _times(2000, cuda_device)
    for _ in range(2):
        got, grid, twin = _cluster_runs(net.step_params(), net.n_exc,
                                        net.conn_all, _fields(state), times)
        _bitwise(got, twin)
        _bitwise(grid, twin)
    assert int(got[4].sum()) > 1000


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_k21_cluster_all_fire_burst(cuda_device, coba):
    """Saturating drive: every neuron fires at the first step (4,000
    rows of 80 DSMEM atomics in one step), bitwise the twin and the
    grid instance."""
    net = bt.EINet(scale=1.0, coba=coba, seed=3, device=cuda_device)
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, device=cuda_device)
    state = _fields(s._replace(neurons=s.neurons._replace(
        v=v, t_last=torch.full_like(v, -1e7))))
    for n in (1, 200):
        times = _times(n, cuda_device)
        got, grid, twin = _cluster_runs(net.step_params(500.0), net.n_exc,
                                        net.conn_all, state, times)
        _bitwise(got, twin)
        _bitwise(grid, twin)
    assert int(_cluster_runs(net.step_params(500.0), net.n_exc,
                             net.conn_all, state, times[:1])[0][4].min()) == 1


@pytest.mark.parametrize('num, n_conn', [
    (1, 80), (33, 80), ('edge', 80), (2000, 8), (8000, 8)],
    ids=['num1', 'num33', 'edge', 'npt2', 'npt4'])
def test_k21_cluster_sizes(cuda_device, num, n_conn):
    """One neuron, 33 (a block of two warps, one neuron on the second),
    the capacity's edge (one neuron more takes the grid), and few targets
    (NPT 2 and 4): bitwise the twin and the grid over 500 steps."""
    if num == 'edge':
        num = _cluster_edge(cuda_device, n_conn)
        assert nw.einet_sim_cluster(num + 1, n_conn, cuda_device) is None
        assert nw.einet_sim_cluster(num, n_conn, cuda_device)[0] > 1
    p, n_exc, conn, state = _cluster_net(cuda_device, num, n_conn)
    times = _times(500, cuda_device)
    got, grid, twin = _cluster_runs(p, n_exc, conn, state, times)
    _bitwise(got, twin)
    _bitwise(grid, twin)


@pytest.mark.parametrize('n', [0, 1, 2, 301])
def test_k21_cluster_few_and_odd_steps(cuda_device, n):
    net = bt.EINet(scale=1.0, device=cuda_device)
    state = _fields(net.run(300))
    times = _times(n, cuda_device, start=300)
    got, grid, twin = _cluster_runs(net.step_params(), net.n_exc,
                                    net.conn_all, state, times)
    _bitwise(got, twin)
    _bitwise(grid, twin)
    if n == 0:
        _bitwise(got, state)


def test_k21_cluster_chained_runs(cuda_device):
    """Two runs through the returned state (the clock going on) equal one
    run of all their steps, bitwise the twin."""
    net = bt.EINet(scale=1.0, device=cuda_device)
    state = _fields(net.init_state())
    p, times = net.step_params(), _times(301, cuda_device)
    first = _cluster_runs(p, net.n_exc, net.conn_all, state, times[:150])[0]
    second = _cluster_runs(p, net.n_exc, net.conn_all, first, times[150:])
    whole = _cluster_runs(p, net.n_exc, net.conn_all, state, times)
    _bitwise(second[0], whole[2])
    _bitwise(second[0], whole[0])


def test_k21_cluster_drops_targets_outside(cuda_device):
    """Targets outside [0, num) (negative, num, far past it) are dropped,
    as the twin and the grid instance drop them."""
    p, n_exc, conn, state = _cluster_net(cuda_device, 4000)
    bad = torch.tensor([-1, 4000, 4007, 2 ** 31 - 1, -2 ** 31],
                       dtype=torch.int32, device=cuda_device)
    conn[::3, ::7] = bad[torch.arange(conn[::3, ::7].numel(),
                                      device=cuda_device).remainder(5)
                         ].view(conn[::3, ::7].shape)
    times = _times(1000, cuda_device)
    got, grid, twin = _cluster_runs(p, n_exc, conn, state, times)
    _bitwise(got, twin)
    _bitwise(grid, twin)
    assert int(got[4].sum()) > 100


def test_run_span_route_by_size_on_card(cuda_device):
    """With tracing on, EINet.run's span names the cluster instance at 4k
    and the grid above the cluster's capacity (12k neurons)."""
    from brainevent_torch.ops import tracing
    routes = []
    for scale in (1.0, 3.0):
        net = bt.EINet(scale=scale, device=cuda_device)
        tracing.enable()
        try:
            net.run(10)
        finally:
            tracing.disable()
        routes.append(tracing.drain()[0].attrs['route'])
    assert routes == ['sim_cluster', 'sim']


def test_step_on_card_is_one_k21_launch(cuda_device):
    net = bt.EINet(scale=0.25, device=cuda_device)
    state = net.init_state()
    bt.reset_launch_counts()
    net.step(state, 0.0)
    assert bt.launch_counts()['einet_sim'] == 1
    assert bt.launch_counts()['einet_step'] == 0


def test_event_scatter_add_float64_and_integer_outputs(cuda_device):
    """C13 and C14 on the card: K2's float64 and integer instances against
    the twin."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    n_cases, err = card.c13_c14_scatter(cuda_device, gen)
    assert n_cases == 6 and err >= 0.0


@pytest.mark.parametrize('dtype', [torch.float64, torch.int32, torch.int64])
def test_event_scatter_float_instances_vs_twin(cuda_device, gen, dtype):
    """The value form's instances on two channels, with sentinels."""
    n_out, n_events = 40_000, 300_000
    targets = torch.from_numpy(gen.integers(-3, n_out + 3, n_events)
                               .astype(np.int32))
    if dtype.is_floating_point:
        values = torch.from_numpy(gen.normal(size=(2, n_events)) * 1e3)
    else:
        values = torch.from_numpy(gen.integers(-1000, 1000, (2, n_events))
                                  ).to(dtype)
    want = sc.event_scatter_float_twin(targets, values,
                                       torch.zeros(2, n_out, dtype=dtype))
    got = sc.event_scatter_float(
        targets.to(cuda_device), values.to(cuda_device),
        torch.zeros(2, n_out, dtype=dtype, device=cuda_device)).cpu()
    torch.cuda.synchronize()
    if dtype.is_floating_point:
        scale = sc.event_scatter_float_twin(
            targets, values.abs(), torch.zeros(2, n_out, dtype=dtype))
        assert bool(((got - want).abs() <= 1e-12 * scale).all())
    else:
        assert torch.equal(got, want)


def test_step_on_card_matches_cpu_step(cuda_device):
    net = bt.EINet(scale=0.25, device=cuda_device)
    cpu = bt.EINet(scale=0.25, conn_all=net.conn_all.cpu(), device='cpu')
    s_cpu, s_gpu = cpu.init_state(), net.init_state()
    for t in cpu.times(50):
        s_cpu = cpu.step(s_cpu, t)
        s_gpu = net.step(s_gpu, t)
    torch.cuda.synchronize()
    assert torch.equal(s_gpu.spike_count.cpu(), s_cpu.spike_count)
    assert torch.equal(s_gpu.neurons.v.cpu(), s_cpu.neurons.v)
    assert torch.equal(s_gpu.g_e.cpu(), s_cpu.g_e)


def _row_bound(plan, w_sorted, x):
    """Per-row sum of |w x| over the plan (the K3/K4 tolerance's scale)."""
    return mg.gather_matvec_xla(plan, w_sorted.abs(), x.abs())


@pytest.mark.parametrize('incoming', [False, True], ids=['out', 'in'])
def test_plan_kernels_vs_twin(cuda_device, gen, incoming):
    n, k = 20_000, 50
    idx = gen.integers(0, n, (n, k))
    if incoming:       # targets as rows: uneven row lengths
        plan = mg.build_gather_plan(idx.reshape(-1), np.repeat(np.arange(n), k),
                                    (n, n))
    else:
        plan = mg.plan_from_ell(idx, (n, n))
    plan = plan.to(cuda_device)
    w = torch.from_numpy(gen.normal(size=n * k).astype(F32)).to(cuda_device)
    w_sorted = plan.sort_data(w)
    x = torch.from_numpy(gen.normal(size=n).astype(F32)).to(cuda_device)
    s = torch.from_numpy((gen.random(n) < 0.18).astype(F32)).to(cuda_device)
    bound = 1e-5 * _row_bound(plan, w_sorted, x) + 1e-30
    y = bt.gather_matvec(plan, w_sorted, x)
    y_twin = mg.gather_matvec_xla(plan, w_sorted, x)
    assert bool(((y - y_twin).abs() <= bound).all())
    assert torch.equal(y, bt.gather_matvec(plan, w_sorted, x))
    y4, dw = bt.plan_matvec_dw(plan, w_sorted, s, x)
    y4_twin, dw_twin = mg.matvec_dw_xla(plan, w_sorted, s, x)
    torch.cuda.synchronize()
    assert torch.equal(y4, y)
    assert torch.equal(dw, dw_twin)
    y4b, dwb = bt.plan_matvec_dw(plan, w_sorted, s, x)
    assert torch.equal(y4b, y4) and torch.equal(dwb, dw)


@pytest.mark.parametrize('incoming', [False, True], ids=['out', 'in'])
def test_plan_gather_rows_bitwise_k4(cuda_device, gen, incoming):
    """K3 over the row index with row-order weights: one launch, bitwise
    K4's y (each lane adds the same slots in the same order), bitwise on a
    repeat, and within the tolerance of the row-order twin."""
    n, k = 20_000, 50
    idx = gen.integers(0, n, (n, k))
    if incoming:       # targets as rows: uneven row lengths
        plan = mg.build_gather_plan(idx.reshape(-1), np.repeat(np.arange(n), k),
                                    (n, n))
    else:
        plan = mg.plan_from_ell(idx, (n, n))
    plan = plan.to(cuda_device)
    w = torch.from_numpy(gen.normal(size=n * k).astype(F32)).to(cuda_device)
    w_row = plan.sort_rows(w)
    assert torch.equal(w_row, plan.rows_of(plan.sort_data(w)))
    x = torch.from_numpy(gen.normal(size=n).astype(F32)).to(cuda_device)
    s = torch.from_numpy((gen.random(n) < 0.18).astype(F32)).to(cuda_device)
    before = mg.plan_gather_mv.launches
    y = mg.plan_gather_mv(plan, w_row, x)
    y4, _ = bt.plan_matvec_dw(plan, plan.sort_data(w), s, x)
    again = mg.plan_gather_mv(plan, w_row, x)
    twin = mg.plan_gather_mv.twin(plan, w_row, x)
    torch.cuda.synchronize()
    assert mg.plan_gather_mv.launches == before + 2
    assert torch.equal(y, y4) and torch.equal(y, again)
    bound = 1e-5 * _row_bound(plan, plan.sort_data(w), x) + 1e-30
    assert bool(((y - twin).abs() <= bound).all())


# plans of K4's redesign: uneven rows with empty ones, several row blocks
# and windows (whole padding chunks), small chunks, a chunk that 4 does not
# divide (the one-slot path), and an empty structure (only padding)
K4_PLANS = {
    'square': ((256, 256), 3000, {}),
    'empty_rows': ((3000, 700), 2000, {}),
    'row_blocks': ((1000, 700), 6000, dict(row_block=128, win_blocks=2)),
    'small_chunks': ((517, 333), 4000, dict(chunk=128, row_block=256)),
    'chunk_102': ((700, 900), 5000, dict(chunk=102)),
    'empty': ((40, 50), 0, {}),
}


def _k4_check(plan, w, s, x):
    """K4 through the public entry with and without the row view, one
    launch each: y bitwise K3's on the same plan (over the row view, and
    through ``gather_matvec``) and bitwise on a repeat, dw bitwise the
    twin's, 0 at every padding slot; K3 within the tolerance of the
    row-order twin."""
    w_sorted, w_row = plan.sort_data(w), plan.sort_rows(w)
    assert torch.equal(w_row, plan.rows_of(w_sorted))
    y3 = mg.plan_gather_mv(plan, w_row, x)
    assert torch.equal(bt.gather_matvec(plan, w_sorted, x), y3)
    before = mg.plan_matvec_dw_op.launches
    y, dw = bt.plan_matvec_dw(plan, w_sorted, s, x)
    y_view, dw_view = bt.plan_matvec_dw(plan, w_sorted, s, x, w_row=w_row)
    again = bt.plan_matvec_dw(plan, w_sorted, s, x, w_row=w_row)
    _, dw_twin = mg.matvec_dw_xla(plan, w_sorted, s, x)
    torch.cuda.synchronize()
    assert mg.plan_matvec_dw_op.launches == before + 3
    assert torch.equal(y, y3) and torch.equal(y_view, y3)
    assert torch.equal(dw, dw_twin) and torch.equal(dw_view, dw_twin)
    assert torch.equal(again[0], y) and torch.equal(again[1], dw)
    assert bool((dw[plan.perm < 0] == 0).all())
    bound = 1e-5 * _row_bound(plan, w_sorted, x) + 1e-30
    assert bool(((y - mg.gather_matvec_xla(plan, w_sorted, x)).abs()
                 <= bound).all())
    assert bool(((y3 - mg.plan_gather_mv.twin(plan, w_row, x)).abs()
                 <= bound).all())


@pytest.mark.parametrize('name', sorted(K4_PLANS))
def test_plan_matvec_dw_small_plans(cuda_device, gen, name):
    shape, nse, kw = K4_PLANS[name]
    rows = gen.integers(0, shape[0], nse)
    if name == 'empty_rows':            # two rows in three have no entry
        rows = 3 * (rows // 3)
    plan = mg.build_gather_plan(rows, gen.integers(0, shape[1], nse), shape,
                                **kw).to(cuda_device)
    if nse:
        assert bool((plan.n_valid < plan.chunk).any())
    assert bool((plan.n_valid == 0).any())      # a whole padding chunk
    w = torch.from_numpy(gen.normal(size=nse).astype(F32)).to(cuda_device)
    s = torch.from_numpy((gen.random(shape[0]) < 0.3).astype(F32)).to(
        cuda_device)
    x = torch.from_numpy(gen.normal(size=shape[1]).astype(F32)).to(
        cuda_device)
    _k4_check(plan, w, s, x)


@pytest.fixture(scope='module')
def big_plans():
    """Both plans of the 100k x 100 training model (built once)."""
    rng = np.random.default_rng(100)
    n, k = 100_000, 100
    idx = rng.integers(0, n, (n, k))
    return n, k, {
        'out': mg.plan_from_ell(idx, (n, n)),
        'in': mg.build_gather_plan(idx.reshape(-1),
                                   np.repeat(np.arange(n), k), (n, n))}


@pytest.mark.parametrize('x_kind', ['normal', 'spikes'])
@pytest.mark.parametrize('incoming', [False, True], ids=['out', 'in'])
def test_plan_matvec_dw_at_full_width(cuda_device, big_plans, incoming,
                                      x_kind):
    n, k, plans = big_plans
    plan = plans['in' if incoming else 'out'].to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(101)
    w = torch.randn(n * k, generator=g, device=cuda_device)
    s = (torch.rand(n, generator=g, device=cuda_device) < 0.18).float()
    x = (torch.randn(n, generator=g, device=cuda_device) if x_kind == 'normal'
         else (torch.rand(n, generator=g, device=cuda_device) < 0.18).float())
    _k4_check(plan, w, s, x)


@pytest.mark.parametrize('rate', [0.0, 0.001, 0.01, 1.0])
@pytest.mark.parametrize('spikes', ['bool', 'float'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
def test_fcn_event_kernels_vs_twin(cuda_device, gen, rate, spikes, homo,
                                   transpose):
    n, k = 100_000, 100
    idx = torch.from_numpy(gen.integers(0, n, (n, k)).astype(np.int32))
    w = torch.from_numpy((gen.normal(size=1) if homo
                          else gen.normal(size=(n, k))).astype(F32))
    on = gen.random(n) < rate
    s = torch.from_numpy(on if spikes == 'bool'
                         else np.where(on, 1.0, -0.5 * gen.random(n))
                         .astype(F32))
    args = [t.to(cuda_device) for t in (w, idx, s)]
    op = fb.fcn_event_scatter if transpose else fb.fcn_event_gather
    before = op.launches
    got = bt.binary_fcnmv(*args, shape=(n, n), transpose=transpose)
    want = op.twin(*args, n)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    if homo:
        assert torch.equal(got, want)
        return
    wabs = args[0].abs()
    bound = op.twin(wabs, args[1], args[2], n)
    tol = 1e-5 if transpose else 1e-6
    assert bool(((got - want).abs() <= tol * bound + 1e-30).all())
    if not transpose:      # no atomics: the same bits on every run
        assert torch.equal(got, bt.binary_fcnmv(*args, shape=(n, n),
                                                transpose=transpose))


def _loss_and_grads(model, p, x, label):
    leaves = [q.clone().requires_grad_(True) for q in p]
    loss = bt.snn_loss(model, bt.SNNParams(*leaves), x, label)
    return loss.detach(), torch.autograd.grad(loss, leaves)


# (n_in, n_hidden, n_out, n_conn) and simulated steps: a small net; the
# 2,000-neuron net that must learn 4 class-templated inputs; the training
# slice at full width (10M recurrent synapses)
TRAIN_NETS = {'small': ((12, 128, 4, 8), 20), 'learn': ((40, 2000, 4, 32), 50),
              'full': ((100, 100_000, 10, 100), 50)}


@pytest.mark.parametrize('width', ['small', 'learn', 'full'])
@pytest.mark.parametrize('forward', ['plan', 'event'])
def test_training_kernels_vs_twin_route(cuda_device, forward, width):
    """A train step launches K3 (K5 with ``forward='event'``) and K4 once a
    simulated step; the gradient of ``w_rec`` is finite and not zero, and
    with ``forward='plan'`` (no float atomics) the loss and gradients are
    bitwise over two calls. The small net
    against the twin route: spike trains equal, loss and gradients within
    tolerance, and the loss and parameters again after 10 train steps
    (at full width the twin's other sum order could flip a spike). The
    2,000-neuron net lowers its loss over 30 epochs at lr 0.5."""
    (n_in, n_hidden, n_out, n_conn), T = TRAIN_NETS[width]
    kw = dict(n_in=n_in, n_hidden=n_hidden, n_out=n_out, n_conn=n_conn,
              seed=3, forward=forward, device=cuda_device)
    model = bt.SurrogateSNN(**kw)
    xs = np.random.default_rng(0).random((n_out, T, n_in)).astype(F32)
    if width == 'learn':
        xs *= 0.2
        for c in range(n_out):
            xs[c, :, 10 * c:10 * c + 10] += 1.0
    xs = torch.from_numpy(xs).to(cuda_device)
    x = xs[1]
    p = model.init_params()
    bt.reset_launch_counts()
    _, loss = bt.train_step(model, p, x, 1)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    key, other = (('fcn_event_scatter', 'plan_gather_mv') if forward == 'event'
                  else ('plan_gather_mv', 'fcn_event_scatter'))
    assert (counts[key], counts['plan_matvec_dw'], counts[other]) == (T, T, 0)
    assert forward == 'event' or sum(counts.values()) == 2 * T
    assert bool(torch.isfinite(loss))
    (la, ga), (lb, gb) = (_loss_and_grads(model, p, x, 1) for _ in range(2))
    assert forward == 'event' or (
        torch.equal(la, lb) and all(map(torch.equal, ga, gb)))
    assert bool(torch.isfinite(ga[1]).all()) and bool((ga[1] != 0).any())
    if width == 'small':
        twin = bt.SurrogateSNN(**kw)
        twin._ops = tr._RecOps(*(op.twin for op in tr._KERNEL_OPS))
        assert torch.equal(model._spikes(p, x), twin._spikes(p, x))
        lb, gb = _loss_and_grads(twin, p, x, 1)
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        pa, pb = p, p
        for _ in range(10):
            pa, la = bt.train_step(model, pa, x, 1)
            pb, lb = bt.train_step(twin, pb, x, 1)
            torch.testing.assert_close(la, lb, rtol=1e-5, atol=0)
        for a, b in zip(pa, pb):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    if width == 'learn':

        def mean_loss(q):
            with torch.no_grad():
                return float(sum(bt.snn_loss(model, q, xs[c], c)
                                 for c in range(n_out)) / n_out)

        l0 = mean_loss(p)
        for _ in range(30):
            for c in range(n_out):
                p, _ = bt.train_step(model, p, xs[c], c, lr=0.5)
        assert mean_loss(p) < l0


# -- the CSR slice: K7-K10 ---------------------------------------------------------

def _random_csr(gen, m, k, density, device):
    """A random CSR structure with empty rows, on *device*."""
    counts = gen.binomial(k, density, m)
    counts[::97] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = gen.integers(0, k, indptr[-1]).astype(np.int32)
    return (torch.from_numpy(indptr).to(device),
            torch.from_numpy(indices).to(device))


def _operand(gen, n, kind, rate, device, batch=None):
    shape = (n,) if batch is None else (n, batch)
    on = gen.random(shape) < rate
    if kind == 'bool':
        x = on
    elif kind == 'gate':
        x = np.where(on, 1.0, -0.5 * gen.random(shape)).astype(F32)
    else:
        x = gen.normal(size=shape).astype(F32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@pytest.mark.parametrize('rate', [0.0, 0.001, 0.01, 0.1, 1.0])
@pytest.mark.parametrize('kind', ['bool', 'gate', 'identity'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('perm', [False, True], ids=['plain', 'perm'])
@pytest.mark.parametrize('transpose', [True, False], ids=['K8', 'K7'])
def test_csr_matvec_kernels_vs_twin(cuda_device, gen, rate, kind, homo, perm,
                                    transpose):
    """K7 and K8 at 10% of (11k, 10k), 11M entries (the CSR slice's size,
    and not square)."""
    from brainevent_torch.csr import pallas_kernels as pk
    m, k = 11_000, 10_000
    indptr, indices = _random_csr(gen, m, k, 0.1, cuda_device)
    nse = indices.shape[0]
    w = torch.from_numpy(gen.normal(size=1 if homo else nse).astype(F32))
    w = w.to(cuda_device)
    p = (torch.from_numpy(gen.permutation(nse).astype(np.int32))
         .to(cuda_device) if perm else None)
    binary = kind != 'identity'
    x = _operand(gen, m if transpose else k, kind,
                 rate if binary else 1.0, cuda_device)
    op = pk.csr_scatter_mv if transpose else pk.csr_gather_mv
    extra = (k,) if transpose else ()
    before = op.launches
    got = op(indptr, indices, p, w, x, binary, *extra)
    want = op.twin(indptr, indices, p, w, x, binary, *extra)
    bound = op.twin(indptr, indices, p, w.abs(),
                    x.abs() if kind == 'identity' else x, binary, *extra)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    if homo and binary:         # integer counts, scaled once: exact
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all())
    if not transpose:           # no atomics: the same bits on every run
        assert torch.equal(got, op(indptr, indices, p, w, x, binary))


@pytest.mark.parametrize('sides', ['both', 'rows', 'cols', 'stdp'])
def test_pair_gather_kernel_vs_twin(cuda_device, gen, sides):
    """K9 bitwise its twin at 10M entries with -1 rows and columns out of
    range, both sides or one; and (``stdp``) the CSR STDP updates of a
    10k x 10k CSR at 10%, clip [0, 1], bitwise ``W + twin``, clipped."""
    from brainevent_torch.ops import pair_gather as pg
    if sides == 'stdp':
        from brainevent_torch.csr._common import (event_gate,
                                                  row_ids_from_indptr)
        indptr, indices = _random_csr(gen, 10_000, 10_000, 0.1, cuda_device)
        W = bt.CSR((torch.from_numpy(gen.random(indices.shape[0]).astype(F32))
                    .to(cuda_device), indices, indptr), shape=(10_000, 10_000))
        rows = row_ids_from_indptr(W.indptr, W.nse)
        spk = torch.from_numpy(gen.random(10_000) < 0.01).to(cuda_device)
        trace = torch.from_numpy(gen.random(10_000).astype(F32)).to(
            cuda_device)
        before = pg.pair_gather.launches
        pre = W.update_on_pre(spk, trace, 0.0, 1.0).data
        post = W.update_on_post(trace, spk, 0.0, 1.0).data
        torch.cuda.synchronize()
        assert pg.pair_gather.launches == before + 2
        assert torch.equal(pre, (W.data + pg.pair_gather_twin(
            rows, W.indices, event_gate(spk), trace)).clamp(0.0, 1.0))
        assert torch.equal(post, (W.data + pg.pair_gather_twin(
            rows, W.indices, trace, event_gate(spk))).clamp(0.0, 1.0))
        return
    n, nse = 30_000, 10_000_003
    rows = gen.integers(-1, n, nse).astype(np.int32)
    cols = gen.integers(0, n + 5, nse).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        rows, cols, gen.normal(size=n).astype(F32),
        gen.normal(size=n).astype(F32))]
    if sides == 'rows':
        args[1] = args[3] = None
    elif sides == 'cols':
        args[0] = args[2] = None
    before = pg.pair_gather.launches
    got = bt.pair_gather_product(*args)
    want = pg.pair_gather_twin(*args)
    torch.cuda.synchronize()
    assert pg.pair_gather.launches == before + 1
    assert torch.equal(got, want)           # one rounding: bitwise


@pytest.mark.parametrize('kind', ['bool', 'gate', 'identity'])
@pytest.mark.parametrize('homo', [True, False], ids=['homo', 'hetero'])
@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
@pytest.mark.parametrize('shape', [(3_000, 2_500, 0.02, 200),
                                   (10_000, 10_000, 0.01, 256),
                                   (10_000, 10_000, 0.1, 16)],
                         ids=['3k', 'csrmm', 'slice'])
def test_csr_gather_mm_kernel_vs_twin(cuda_device, gen, shape, kind, homo,
                                      transpose):
    """K10 through ``csrmm``/``binary_csrmm`` within ``1e-5 * sum|w x|``
    of the twin (homogeneous binary exact), bitwise its stored-order sum
    and on a repeat: at (3k, 2.5k, 2%, B = 200), the csrmm cell (10k, 10k,
    1%, B = 256) and the CSR slice's (10k, 10k, 10%, B = 16)."""
    m, k, density, B = shape
    indptr, indices = _random_csr(gen, m, k, density, cuda_device)
    nse = indices.shape[0]
    w = torch.from_numpy(gen.normal(size=1 if homo else nse).astype(F32))
    w = w.to(cuda_device)
    binary = kind != 'identity'
    X = _operand(gen, m if transpose else k, kind, 0.1 if binary else 1.0,
                 cuda_device, batch=B)
    fn = bt.binary_csrmm if binary else bt.csrmm
    before = mg.csr_gather_mm.launches
    got = fn(w, indices, indptr, X, shape=(m, k), transpose=transpose)
    torch.cuda.synchronize()
    assert mg.csr_gather_mm.launches == before + 1
    ptr, idx, perm = indptr, indices, None
    if transpose:
        ptr, idx, perm = bt._misc.csr_to_csc_index(indptr, indices,
                                                   shape=(m, k))
    want = mg.csr_gather_mm_twin(ptr, idx, None if homo else perm, w, X,
                                 binary)
    bound = mg.csr_gather_mm_twin(ptr, idx, None if homo else perm, w.abs(),
                                  X.abs() if kind == 'identity' else X,
                                  binary)
    if homo and binary:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all())
    assert torch.equal(got, mg.csr_gather_mm_ordered(
        ptr, idx, None if homo else perm, w, X, binary))
    assert torch.equal(got, fn(w, indices, indptr, X, shape=(m, k),
                               transpose=transpose))


def _mm_structure(gen, m, k, device):
    """A CSR structure with empty rows and a few 1000-entry rows."""
    counts = gen.integers(0, 12, m)
    counts[::7] = 0
    counts[3::101] = 1000
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = gen.integers(0, k, indptr[-1]).astype(np.int32)
    return (torch.from_numpy(indptr).to(device),
            torch.from_numpy(indices).to(device))


def _offset_operand(x, offset):
    """*x* copied into a buffer at *offset* elements: contiguous, but not
    16-byte aligned for an offset that is not a multiple of 16 bytes."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize('kind', ['bool', 'gate', 'identity'])
@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
@pytest.mark.parametrize('B', [1, 3, 4, 16, 17, 64, 128, 255, 256, 300])
def test_csr_gather_mm_bitwise_ordered_sum(cuda_device, gen, B, transpose,
                                           kind):
    """K10 bitwise its stored-order plain sum, homogeneous and per-entry
    weights, X 16-byte aligned and not (an offset view), over rows that
    are empty or hold 1000 entries; NT over the CSR arrays, T over the
    CSC mirror with its permutation; one launch per call, repeats
    bitwise."""
    m, k = 600, 1500
    indptr, indices = _mm_structure(gen, m, k, cuda_device)
    ptr, idx, perm = indptr, indices, None
    if transpose:
        ptr, idx, perm = bt._misc.csr_to_csc_index(indptr, indices,
                                                   shape=(m, k))
    n_x = m if transpose else k
    binary = kind != 'identity'
    X0 = _operand(gen, n_x, kind, 0.2 if binary else 1.0, cuda_device,
                  batch=B)
    nse = indices.shape[0]
    for homo in (True, False):
        w = torch.from_numpy(gen.normal(size=1 if homo else nse).astype(F32))
        w = w.to(cuda_device)
        p = None if homo else perm
        for offset in (0, 1):
            X = _offset_operand(X0, offset)
            before = mg.csr_gather_mm.launches
            got = mg.csr_gather_mm(ptr, idx, p, w, X, binary)
            torch.cuda.synchronize()
            assert mg.csr_gather_mm.launches == before + 1
            want = mg.csr_gather_mm_ordered(ptr, idx, p, w, X, binary)
            assert got.shape == want.shape == (ptr.shape[0] - 1, B)
            assert torch.equal(got, want), (homo, offset)
            assert torch.equal(got, mg.csr_gather_mm(ptr, idx, p, w, X,
                                                     binary))


@pytest.mark.parametrize('kind', ['bool', 'identity'])
@pytest.mark.parametrize('transpose', [False, True], ids=['NT', 'T'])
@pytest.mark.parametrize('B', [3, 16, 256])
def test_csr_gather_mm_float64_bitwise_ordered_sum(cuda_device, gen, B,
                                                   transpose, kind):
    """K10's double instance bitwise its float64 stored-order sum."""
    m, k = 300, 400
    indptr, indices = _mm_structure(gen, m, k, cuda_device)
    ptr, idx, perm = indptr, indices, None
    if transpose:
        ptr, idx, perm = bt._misc.csr_to_csc_index(indptr, indices,
                                                   shape=(m, k))
    binary = kind != 'identity'
    X = _operand(gen, m if transpose else k, kind, 0.2, cuda_device, batch=B)
    if not binary:
        X = X.double()
    w = torch.from_numpy(gen.normal(size=indices.shape[0])).to(cuda_device)
    before = mg.csr_gather_mm.launches
    got = mg.csr_gather_mm(ptr, idx, perm, w, X, binary)
    torch.cuda.synchronize()
    assert mg.csr_gather_mm.launches == before + 1
    assert got.dtype == torch.float64
    assert torch.equal(got, mg.csr_gather_mm_ordered(ptr, idx, perm, w, X,
                                                     binary))


@pytest.mark.parametrize('shape', [(4_000, 3_000, 120_000),
                                   (10_000, 10_000, 1_000_000)],
                         ids=['4k', 'csrmm'])
def test_gather_matmat_kernel_vs_twin(cuda_device, gen, shape):
    """``gather_matmat`` over an mm plan (K10 over its row index) within
    ``1e-5 * sum|w x|`` of the twin, bitwise its stored-order sum and on a
    repeat; at the csrmm cell's size, 1M entries, too."""
    M, N, nse = shape
    B = 256
    rows, cols = gen.integers(0, M, nse), gen.integers(0, N, nse)
    plan = mg.build_mm_plan(rows, cols, (M, N)).to(cuda_device)
    w_sorted = plan.sort_data(torch.from_numpy(
        gen.normal(size=nse).astype(F32)).to(cuda_device))
    X = torch.from_numpy(gen.normal(size=(N, B)).astype(F32)).to(cuda_device)
    got = bt.gather_matmat(plan, w_sorted, X)
    want = mg.gather_matmat_xla(plan, w_sorted, X)
    bound = mg.gather_matmat_xla(plan, w_sorted.abs(), X.abs())
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all())
    assert torch.equal(got, mg.csr_gather_mm_ordered(
        plan.row_ptr, plan.row_cols, plan.row_slots, w_sorted.reshape(-1), X,
        False))
    assert torch.equal(got, bt.gather_matmat(plan, w_sorted, X))


CSR_OPS = ('csr_gather_mv', 'csr_scatter_mv', 'pair_gather', 'csr_gather_mm')


def _csr_slice(W, inputs):
    """The CSR slice, a step per entry of *inputs* ``(spk, pspk, X, Z)``:
    the event products both ways, trace decay, STDP with clip [0, 1],
    ``W @ X`` and ``Z @ W``; the final matrix and each step's products."""
    dev = W.device
    pre = post = torch.zeros(W.shape[0], device=dev)
    outs = []
    for spk, pspk, X, Z in inputs:
        spk, pspk, X, Z = (t.to(dev) for t in (spk, pspk, X, Z))
        a = bt.BinaryArray(spk) @ W
        b = W @ bt.BinaryArray(pspk)
        pre, post = pre * 0.95 + spk, post * 0.95 + pspk
        W = W.update_on_pre(spk, post, 0.0, 1.0).update_on_post(
            pre, pspk, 0.0, 1.0)
        outs.append((a, b, W @ X, Z @ W))
    return W, outs


def _rel(a, b):
    """``max|a - b|`` over ``max(max|b|, 1)``, on the CPU."""
    a, b = a.cpu(), b.cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1.0))


@pytest.mark.parametrize('reference', ['cpu', 'twins'])
def test_csr_slice_on_card_matches_cpu(cuda_device, gen, reference):
    """The CSR slice on the card against the same steps on a reference:
    the CPU (2k x 2k at 5%, 5 steps) or the twins on the card (10k x 10k
    at 10%, 10M entries, 100 steps). ``W.data`` bitwise at the end (K9's
    one rounding), the products within 1e-5 relative, K7 and K8 once and
    K9 and K10 twice a step; a backward through ``W @ v`` (dW bitwise, dv
    within 1e-5 relative); ``W @ X`` at B = 256 in one launch."""
    from brainevent_torch.ops.core import REGISTRY
    n, density, n_steps, rate = ((2_000, 0.05, 5, 0.05) if reference == 'cpu'
                                 else (10_000, 0.1, 100, 0.01))
    indptr, indices = _random_csr(gen, n, n, density, 'cpu')
    data = torch.from_numpy(gen.random(indices.shape[0]).astype(F32))

    def csr(dev):
        return bt.CSR((data.to(dev), indices, indptr), shape=(n, n))

    inputs = [tuple(torch.from_numpy(a) for a in (
        gen.random(n) < rate, gen.random(n) < rate,
        gen.normal(size=(n, 16)).astype(F32),
        gen.normal(size=(16, n)).astype(F32))) for _ in range(n_steps)]
    ops = [REGISTRY[name] for name in CSR_OPS]

    def twins():
        return card.twins_on_card(ops if reference == 'twins' else [])

    ref_dev = cuda_device if reference == 'twins' else torch.device('cpu')
    bt.reset_launch_counts()
    W, outs = _csr_slice(csr(cuda_device), inputs)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert {k: counts[k] for k in CSR_OPS} == dict(
        csr_gather_mv=n_steps, csr_scatter_mv=n_steps,
        pair_gather=2 * n_steps, csr_gather_mm=2 * n_steps)
    with twins():
        W_ref, outs_ref = _csr_slice(csr(ref_dev), inputs)
    assert torch.equal(W.data.cpu(), W_ref.data.cpu())     # K9 bitwise
    for got, want in zip(outs, outs_ref):
        for a, b in zip(got, want):
            assert a.shape == b.shape and _rel(a, b) <= 1e-5
    v = torch.from_numpy(gen.normal(size=n).astype(F32))
    ct = torch.from_numpy(gen.normal(size=n).astype(F32))
    X = torch.from_numpy(gen.normal(size=(n, 256)).astype(F32))
    grads = []
    for M, dev, ctx in ((W, cuda_device, lambda: card.twins_on_card([])),
                        (W_ref, ref_dev, twins)):
        w = M.data.clone().requires_grad_(True)
        vv = v.to(dev).requires_grad_(True)
        with ctx():
            y = M.with_data(w) @ vv
            grads.append((y.detach(), *torch.autograd.grad(
                y, (vv, w), ct.to(dev)), M @ X.to(dev)))
    (yk, gvk, gwk, Yk), (yt, gvt, gwt, Yt) = grads
    torch.cuda.synchronize()
    assert torch.equal(gwk.cpu(), gwt.cpu())
    for a, b in ((yk, yt), (gvk, gvt), (Yk, Yt)):
        assert _rel(a, b) <= 1e-5
    bt.reset_launch_counts()
    W @ X.to(cuda_device)
    assert bt.launch_counts()['csr_gather_mm'] == 1


def test_new_ops_raise_without_kernel_library(cuda_device, monkeypatch,
                                              tmp_path):
    """A CUDA tensor reaching a new op with no kernel library raises; the
    twin does not run."""
    from brainevent_torch.csr import pallas_kernels as pk
    from brainevent_torch.ops import cuda_build
    from brainevent_torch.ops import pair_gather as pg
    monkeypatch.setattr(cuda_build, '_lib', None)
    monkeypatch.setattr(cuda_build, '_functions', {})
    monkeypatch.setenv('BRAINEVENT_TORCH_BUILD_DIR', str(tmp_path))

    def no_nvcc():
        raise bt.NvccNotFoundError('no nvcc')

    monkeypatch.setattr(cuda_build, 'find_nvcc', no_nvcc)
    calls = []
    for op in (pk.csr_gather_mv, pk.csr_scatter_mv, pg.pair_gather,
               mg.csr_gather_mm):
        monkeypatch.setattr(op, 'twin', lambda *a, **k: calls.append(a))
    A = bt.CSR.fromdense(torch.eye(4, device=cuda_device))
    v = torch.ones(4, device=cuda_device)
    for call in (lambda: A @ v, lambda: bt.BinaryArray(v > 0) @ A,
                 lambda: A @ torch.ones(4, 3, device=cuda_device),
                 lambda: A.update_on_pre(v > 0, v)):
        with pytest.raises(bt.NvccNotFoundError):
            call()
    assert calls == []


# -- K11-K14: the JITC walk ------------------------------------------------------

JITC_LAWS = [(0, 0.5, 0.0), (1, 0.6, 0.06), (2, 0.48, 0.24)]


@pytest.mark.parametrize('shape', [(1000, 777, 0.05), (5120, 5120, 0.01)],
                         ids=['1000x777', '5120'])
@pytest.mark.parametrize('law', JITC_LAWS, ids=['scalar', 'normal',
                                                'uniform'])
def test_jitc_setup_and_todense_kernels_bitwise(cuda_device, law, shape):
    """K14 (both strides, both orders) and K11 (both strides) bitwise the
    twins; at (5120, 5120, 1%) under the normal law, the class surface
    (``M @ v``, ``v @ M``, ``plan @ B``, ``M @ B``, ``B.T @ M``) within 1e-5
    relative of the products with its dense matrices, launching K11 twice,
    K12 twice, K13 three times (stride 32 once) and K14 once a stride."""
    from brainevent_torch._misc import _initialize_conn_length
    from brainevent_torch.jitc import pallas_kernels as jk
    code, a, b = law
    m, k, prob = shape
    cl, chunk = _initialize_conn_length(prob), -(-k // 4)
    for corder in (True, False):
        for op in (jk.jitc_walk_todense, jk.jitc_walk_todense4):
            got = torch.zeros(m, k, device=cuda_device)
            op(got, None, None, law=code, a=a, b=b, seed=5, cl=cl,
               corder=corder)
            want = op.twin(torch.zeros_like(got), None, None, law=code, a=a,
                           b=b, seed=5, cl=cl, corder=corder)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (op.name, corder)
    for stride in (32, 4):
        L = -(-k // chunk) * stride
        s, q = (torch.empty(m, L, dtype=torch.int32, device=cuda_device)
                for _ in range(2))
        kw = dict(seed=9, cl=cl, n_rows=m, n_cols=k, chunk_size=chunk,
                  stride=stride)
        jk.jitc_walk_setup(s, q, **kw)
        s2, q2 = jk.jitc_walk_setup.twin(torch.empty_like(s),
                                         torch.empty_like(q), **kw)
        torch.cuda.synchronize()
        assert torch.equal(s, s2) and torch.equal(q, q2)
    if code != 1 or m != k:
        return
    g = torch.Generator(device=cuda_device).manual_seed(19)
    M = bt.JITCNormalR((a, b, prob, 2024), shape=(m, k), corder=True,
                       device=cuda_device)
    v = torch.randn(k, generator=g, device=cuda_device)
    B = torch.randn(k, 256, generator=g, device=cuda_device)
    bt.reset_launch_counts()
    D, D4 = M.todense(), M.mm.todense()
    outs = {'M @ v': (M @ v, D @ v), 'v @ M': (v @ M, v @ D),
            'plan @ B': (M.build_walk_plan() @ B, D @ B),
            'M @ B': (M @ B, D4 @ B), 'B.T @ M': (B.T @ M, B.T @ D4)}
    torch.cuda.synchronize()
    assert {n: c for n, c in bt.launch_counts().items()
            if n.startswith('jitc')} == {
        'jitc_walk_setup': 2, 'jitc_walk_mv': 2, 'jitc_walk_mm': 1,
        'jitc_walk_mm4': 2, 'jitc_walk_todense': 1, 'jitc_walk_todense4': 1}
    for what, (got, want) in outs.items():
        assert got.shape == want.shape, what
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5, what


@pytest.mark.parametrize('kind', ['bool', 'events', 'float'])
@pytest.mark.parametrize('corder', [True, False], ids=['gather', 'scatter'])
@pytest.mark.parametrize('law', JITC_LAWS, ids=['scalar', 'normal',
                                                'uniform'])
@pytest.mark.parametrize('dims', [(2000, 1500, 100, 40), (5120, 5120, 200, 16),
                                  (5120, 5120, 200, 256)],
                         ids=['2000x1500', '5120-B16', '5120-B256'])
def test_jitc_products_kernel_vs_twin(cuda_device, gen, dims, law, corder,
                                      kind):
    """K12 (over a plan and drawing its own setup) and K13 (both strides)
    within 1e-5 * sum|w x| of the twin; gathers bitwise on a repeat. At
    (5120, 5120, 1%) each output also within 1e-5 of its sum over the
    dense |W| the walk of its stride draws (K14) times the gate."""
    from brainevent_torch.jitc import pallas_kernels as jk
    code, a, b = law
    n_rows, n_cols, cl, n_b = dims
    in_len = n_cols if corder else n_rows
    chunk = -(-n_cols // 4)
    s, q, _ = jk.walk_plan_setup(3, cl, n_rows, n_cols, chunk,
                                 device=cuda_device)

    def operand(shape):
        if kind == 'bool':
            return torch.from_numpy(gen.random(shape) < 0.1).to(cuda_device)
        x = gen.normal(size=shape).astype(F32)
        return torch.from_numpy(x).to(cuda_device)

    kw = dict(law=code, a=a, b=b, seed=3, cl=cl, n_rows=n_rows,
              n_cols=n_cols, logical_cols=n_cols, corder=corder,
              event=kind != 'float')
    absw = dict(kw, a=abs(a), law=code if code != 1 else 0, b=b)
    dense = {}
    if n_rows == n_cols:
        for stride, op in ((32, jk.jitc_walk_todense),
                           (4, jk.jitc_walk_todense4)):
            dense[stride] = op(torch.zeros(n_rows, n_cols, device=cuda_device),
                               None, None, law=code, a=a, b=b, seed=3, cl=cl,
                               corder=corder).abs()
    for op, x, plan in ((jk.jitc_walk_mv, operand(in_len), (s, q)),
                        (jk.jitc_walk_mv, operand(in_len), (None, None)),
                        (jk.jitc_walk_mm, operand((in_len, n_b)), (s, q)),
                        (jk.jitc_walk_mm4, operand((in_len, n_b)),
                         (None, None))):
        got = op(*plan, x, **kw)
        want = op.twin(*plan, x, **kw)
        xa = x if x.dtype == torch.bool else x.abs()
        scale = op.twin(*plan, xa, **(kw if code == 1 else absw))
        torch.cuda.synchronize()
        assert got.shape == want.shape
        tol = 1e-5 * scale.abs() + 1e-5 * float(want.abs().max())
        assert bool(((got - want).abs() <= tol).all()), op.name
        if dense:
            gate = (x.float() if x.dtype == torch.bool else
                    (x > 0).float() if kw['event'] else x.abs())
            bound = dense[4 if op is jk.jitc_walk_mm4 else 32] @ gate
            card.within(got, want, bound, op.name)
        if corder:
            again = op(*plan, x, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again), op.name


@pytest.mark.parametrize('kind', ['bool', 'events'])
@pytest.mark.parametrize('rate', [0.0, 1e-4, 0.01, 0.1, 1.0])
@pytest.mark.parametrize('n_rows', [1, 31, 33, 64_000])
def test_jitc_event_scatter_kernel_vs_twin(cuda_device, gen, n_rows, rate,
                                           kind):
    """K12's event scatter (the active rows only) within 1e-5 * sum|w x|
    of the twin, over a plan and drawing its own setup, from row 0 and
    from a row offset; one launch per call."""
    from brainevent_torch.jitc import pallas_kernels as jk
    n_cols = 80_000 if n_rows == 64_000 else 5_000
    cl, chunk = 2_000, -(-n_cols // 4)
    on = gen.random(n_rows) < rate
    x = on if kind == 'bool' else np.where(
        on, 1.0, -0.5 * gen.random(n_rows)).astype(F32)
    x = torch.from_numpy(x).to(cuda_device)
    kw = dict(law=1, a=0.6, b=float(F32(0.06)), seed=5, cl=cl,
              n_rows=n_rows, n_cols=n_cols, logical_cols=n_cols,
              corder=False, event=True)
    for row0 in (0, 777):
        s, q, _ = jk.walk_plan_setup(5, cl, n_rows, n_cols, chunk,
                                     device=cuda_device, row0=row0)
        for plan in ((s, q), (None, None)):
            before = jk.jitc_walk_mv.launches
            got = jk.jitc_walk_mv(*plan, x, row0=row0, **kw)
            torch.cuda.synchronize()
            assert jk.jitc_walk_mv.launches == before + 1
            want = jk.jitc_walk_mv.twin(*plan, x, row0=row0, **kw)
            scale = jk.jitc_walk_mv.twin(*plan, x, row0=row0,
                                         **dict(kw, law=0, a=0.6 + 6 * 0.06))
            assert got.shape == want.shape == (n_cols,)
            if rate == 0.0:
                assert not got.any()
            assert bool(((got - want).abs() <= 1e-5 * scale).all()), (
                row0, plan[0] is None)


@pytest.mark.parametrize('scale', [1.0, 20.0], ids=['4k', '80k'])
@pytest.mark.parametrize('law', ['scalar', 'normal'])
def test_jitc_net_on_card_matches_twin(cuda_device, law, scale):
    """2,000 steps of a JITCNet (4k, and 80k at scale 20) through K12, one
    launch per projection per step after the two plans' K11; 20 of its
    steps, from the run's states, equal to the twin route's (spikes and v
    bitwise, drives within 1e-5 relative). The scalar law's spike counts
    equal the twin loop's over the whole run; the normal law fires at
    1-200 Hz, its rate over the first 200 steps within 2% of the twin
    loop's."""
    from brainevent_torch.jitc import pallas_kernels as jk
    n_steps = 2000
    bt.reset_launch_counts()
    net = bt.JITCNet(scale=scale, weight_law=law, device=cuda_device)
    assert bt.launch_counts()['jitc_walk_setup'] == 2
    state = s = net.init_state()
    kept = []
    bt.reset_launch_counts()
    for i, t in enumerate(net.times(n_steps)):
        if i % 100 == 0:
            kept.append((t, s))
        if i == 200:
            first = s
        s = net.step(s, t)
    torch.cuda.synchronize()
    assert {k: c for k, c in bt.launch_counts().items()
            if k.startswith('jitc')} == dict(
        jitc_walk_setup=0, jitc_walk_mv=2 * n_steps, jitc_walk_mm=0,
        jitc_walk_mm4=0, jitc_walk_todense=0, jitc_walk_todense4=0)
    twin_route = lambda: card.twins_on_card([jk.jitc_walk_mv])  # noqa: E731
    for t, st in kept:
        a = net.step(st, t)
        with twin_route():
            b = net.step(st, t)
        torch.cuda.synchronize()
        assert torch.equal(a.spike_count, b.spike_count)
        assert torch.equal(a.neurons.v, b.neurons.v)
        for x, y in ((a.g_e, b.g_e), (a.g_i, b.g_i)):
            assert float((x - y).abs().max() / y.abs().max().clamp(
                min=1e-30)) <= 1e-5
    if law == 'scalar':
        with twin_route():
            want = net.run(n_steps, state=state)
        assert torch.equal(s.spike_count, want.spike_count)
    else:
        assert 1.0 < float(net.firing_rate_hz(s, n_steps)) < 200.0
        with twin_route():
            want = net.run(200, state=state)
        r_got = float(net.firing_rate_hz(first, 200))
        r_want = float(net.firing_rate_hz(want, 200))
        assert abs(r_got - r_want) <= 0.02 * r_want


# -- the dense slice and the encoders: K15-K18 --------------------------------------

def _dense_spikes(gen, shape, rate, kind, device):
    """bool, or float32 with negatives and NaN among the silent entries
    (the products gate at > 0)."""
    on = gen.random(shape) < rate
    if kind == 'bool':
        return torch.from_numpy(on).to(device)
    x = np.where(on, gen.uniform(0.5, 2.0, shape), -gen.random(shape))
    x[(~on) & (gen.random(shape) < 0.2)] = np.nan
    return torch.from_numpy(x.astype(F32)).to(device)


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('rate', [0.0, 0.01, 1.0])
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
@pytest.mark.parametrize('shape', [(1500, 1100, 70), (10_000, 10_000, 128)],
                         ids=['1500x1100', '10k'])
def test_dense_event_products_kernel_vs_twin(cuda_device, gen, shape,
                                             transpose, rate, kind):
    """K15 and K16 within 1e-5 * sum|W| * gate per output of the twin, and
    bitwise on a repeat; at the dense slice's (10k, 10k), B = 128, too."""
    from brainevent_torch.dense import pallas_kernels as dk
    m, k, n_b = shape
    W = torch.from_numpy(gen.normal(size=(m, k)).astype(F32)).to(
        cuda_device)
    n_in = W.shape[0] if transpose else W.shape[1]
    for op, s in ((dk.dense_event_mv, _dense_spikes(gen, (n_in,), rate, kind,
                                                    cuda_device)),
                  (dk.dense_event_mm, _dense_spikes(gen, (n_in, n_b), rate,
                                                    kind, cuda_device))):
        got = op(W, s, transpose)
        want = op.twin(W, s, transpose)
        bound = op.twin(W.abs(), s, transpose)
        again = op(W, s, transpose)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all()), \
            op.name
        assert torch.equal(got, again), op.name


def _k15_check(W, s, transpose):
    """K15 one launch a call: within 1e-5 * sum|W| gate of the twin and
    bitwise on a repeat; ``s @ W`` bitwise the ascending-row loop
    (``card.ordered_event_mm`` of ``s`` as one column)."""
    from brainevent_torch.dense import pallas_kernels as dk
    op = dk.dense_event_mv
    before = op.launches
    got = op(W, s, transpose)
    again = op(W, s, transpose)
    want = card.ordered_event_mm(W, s[:, None], True)[:, 0] \
        if transpose else None
    twin = op.twin(W, s, transpose)
    bound = op.twin(W.abs(), s, transpose)
    torch.cuda.synchronize()
    assert op.launches == before + 2
    assert got.shape == twin.shape and got.dtype == W.dtype
    assert torch.equal(got, again)
    assert not transpose or torch.equal(got, want)
    assert bool(((got - twin).abs() <= 1e-5 * bound + 1e-30).all())


def _k15_weights(k, m, transpose, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((k, m) if transpose else (m, k), generator=g,
                       device=device, dtype=dtype)


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('rate', [0.0, 0.001, 0.01, 0.1, 1.0])
@pytest.mark.parametrize('m', [1, 33, 10_000])
@pytest.mark.parametrize('k', [1, 31, 32, 33, 10_000, 70_000])
def test_dense_event_mv_kernel(cuda_device, gen, k, m, rate, kind):
    """K15 both ways at k from one gate to 70,000 (five 16,384-gate
    tiles) and m from 1 to 10,000, float spikes with negatives, NaN and
    +-0 among the silent ones (``_k15_check``)."""
    s = _dense_spikes(gen, (k,), rate, kind, cuda_device)
    if kind == 'float':
        s[:k // 3] = torch.where(s[:k // 3] > 0, s[:k // 3], torch.tensor(
            [0.0, -0.0], device=cuda_device).repeat(k)[:k // 3])
    for transpose in (True, False):
        _k15_check(_k15_weights(k, m, transpose, torch.float32, cuda_device,
                                k + m), s, transpose)


@pytest.mark.parametrize('rate', [0.001, 0.1, 1.0])
@pytest.mark.parametrize('km', [(33, 10_000), (10_000, 33), (10_000, 10_000)],
                         ids=str)
def test_dense_event_mv_float64_kernel(cuda_device, gen, km, rate):
    """K15's ``double`` instance (C10) at the same standard."""
    k, m = km
    for kind in ('bool', 'float'):
        s = _dense_spikes(gen, (k,), rate, kind, cuda_device)
        for transpose in (True, False):
            _k15_check(_k15_weights(k, m, transpose, torch.float64,
                                    cuda_device, k), s, transpose)


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('rate', [0.0, 0.01, 0.5])
@pytest.mark.parametrize('transpose', [True, False], ids=['T', 'NT'])
@pytest.mark.parametrize('shape', [(300, 333, 77), (5000, 5000, 128)],
                         ids=['300x333', '5000'])
def test_dense_event_mm_bitwise_ordered_loop(cuda_device, gen, shape,
                                             transpose, rate, kind):
    """K16 is the plain ascending-k sum: bitwise ``Y += W[:, i] * g(S[i])``
    over i in order (``card.ordered_event_mm``), at a shape off the
    kernel's 64-row tiles and at (5000, 5000, B = 128), float spikes with
    negatives and NaN among the silent ones."""
    from brainevent_torch.dense import pallas_kernels as dk
    m, k, n = shape
    W = torch.from_numpy(gen.normal(size=(k, m) if transpose else (m, k))
                         .astype(F32)).to(cuda_device)
    S = _dense_spikes(gen, (k, n), rate, kind, cuda_device)
    got = dk.dense_event_mm(W, S, transpose)
    want = card.ordered_event_mm(W, S, transpose)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize('shape', [(1000, 1200), (301, 257),
                                   (10_000, 10_000)], ids=str)
@pytest.mark.parametrize('clip', [(None, None), (-1.0, 1.0), (None, 0.25)],
                         ids=str)
@pytest.mark.parametrize('kind', ['bool', 'float'])
def test_dense_stdp_kernel_vs_twin(cuda_device, gen, kind, clip, shape):
    """K17 on-pre and on-post bitwise the twins, with and without the clip,
    on rows that take 16-byte accesses and rows that do not, and on the
    dense slice's 100M weights."""
    from brainevent_torch.dense import pallas_kernels as dk
    m, n = shape
    W = torch.from_numpy(gen.normal(size=shape).astype(F32)).to(cuda_device)
    t_n = torch.from_numpy(gen.normal(size=n).astype(F32)).to(cuda_device)
    t_m = torch.from_numpy(gen.normal(size=m).astype(F32)).to(cuda_device)
    for op, args in (
            (dk.dense_stdp_pre, (W, _nonzero_spikes(gen, m, kind,
                                                    cuda_device), t_n)),
            (dk.dense_stdp_post, (W, t_m, _nonzero_spikes(gen, n, kind,
                                                          cuda_device)))):
        got = op(*args, *clip)
        want = op.twin(*args, *clip)
        torch.cuda.synchronize()
        assert torch.equal(got, want), op.name


def _nonzero_spikes(gen, n, kind, device):
    """Spikes for the != 0 gate: bool, or float with negative and NaN
    events."""
    on = gen.random(n) < 0.1
    if kind == 'bool':
        return torch.from_numpy(on).to(device)
    x = np.where(on, gen.choice([1.0, -1.0, np.nan], n), 0.0).astype(F32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize('kind', ['bool', 'float'])
@pytest.mark.parametrize('shape', [(10_000, 128), (16, 8192), (37, 33)],
                         ids=str)
def test_event_row_count_kernel_vs_twin(cuda_device, gen, shape, kind):
    """K18 equal to its twin (integer counts); the encoders on the card
    equal to their results on the CPU."""
    from brainevent_torch.events import pallas_kernels as ek
    on = gen.random(shape) < 0.05
    x = (on if kind == 'bool' else
         np.where(on, gen.choice([1.0, -1.0, np.nan], shape), 0.0).astype(F32))
    xd, xc = torch.from_numpy(x).to(cuda_device), torch.from_numpy(x)
    got = ek.event_row_count(xd)
    torch.cuda.synchronize()
    assert torch.equal(got, ek.event_row_count_twin(xd))
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32),
                        torch.cumsum(got.cpu(), 0, dtype=torch.int32)])
    for fn, args_d, args_c in (
            (bt.binary_2d_csr_encode_p_call, (xd,), (xc,)),
            (bt.binary_2d_csc_encode_p_call, (xd,), (xc,)),
            (bt.binary_2d_pair_stream_encode_p_call, (xd,), (xc,)),
            (bt.binary_2d_array_index_p_call, (xd,), (xc,)),
            (bt.binary_2d_compact_only_p_call, (xd,), (xc,)),
            (bt.binary_2d_row_sparse_encode_p_call, (xd,), (xc,)),
            (bt.binary_2d_csr_fill_p_call, (xd, indptr.to(cuda_device)),
             (xc, indptr)),
            (bt.binary_1d_array_index_p_call, (xd[0],), (xc[0],))):
        for a, b in zip(fn(*args_d), fn(*args_c)):
            assert torch.equal(a.cpu(), b), fn.__name__


DENSE_OPS = ('dense_event_mv', 'dense_event_mm', 'dense_stdp_pre',
             'dense_stdp_post', 'event_row_count')


def _dense_slice(W, n_steps, device, bounds=False):
    """The dense slice from ``Dense`` *W*: a step is ``s @ W`` and ``W @
    s`` at 1%, the traces' decay, STDP on-pre and on-post with clip [-1,
    1], ``W @ S`` (S (n, 128) at 1%) and the encoders of S. Returns the
    final matrix, each step's products and counts, and with *bounds* the
    products' ``sum|W| gate`` bounds."""
    from brainevent_torch.dense import pallas_kernels as dk
    g = torch.Generator(device=device).manual_seed(23)
    n = W.shape[0]
    pre_tr = post_tr = torch.zeros(n, device=device)
    outs, bnds = [], []
    for _ in range(n_steps):
        pre = torch.rand(n, generator=g, device=device) < 0.01
        post = torch.rand(n, generator=g, device=device) < 0.01
        S = torch.rand(n, 128, generator=g, device=device) < 0.01
        a = bt.BinaryArray(pre) @ W
        b = W @ bt.BinaryArray(post)
        pre_tr, post_tr = pre_tr * 0.95 + pre, post_tr * 0.95 + post
        W = W.update_on_pre(pre, post_tr, -1.0, 1.0)
        W = W.update_on_post(pre_tr, post, -1.0, 1.0)
        c = W @ bt.BinaryArray(S)
        _, indptr = bt.binary_2d_csr_encode_p_call(S)
        outs.append((a, b, c, bt.CompactBinary.from_array(S).n_active,
                     indptr[-1:]))
        if bounds:
            w_abs = W.data.abs()
            bnds.append((dk.dense_event_mv.twin(w_abs, pre, True),
                         dk.dense_event_mv.twin(w_abs, post, False),
                         dk.dense_event_mm.twin(w_abs, S, False)))
    return W, outs, bnds


def test_dense_slice_routes_through_k15_k18(cuda_device):
    """100 steps of the dense slice at (10k, 10k), 100M weights, launch K15
    twice, K16 once, K17 twice and K18 once a step; against the same steps
    through the twins on the card, ``W.data`` bitwise at the end (K17's
    one rounding), the products within 1e-5 * sum|W| gate, the encoders'
    counts equal. A backward through ``W @ BinaryArray(float spikes)``:
    dW and dx bitwise the twin route's, y within tolerance."""
    from brainevent_torch.ops.core import REGISTRY
    n, n_steps = 10_000, 100
    ops = [REGISTRY[name] for name in DENSE_OPS]
    W0 = bt.Dense(torch.randn(n, n, generator=torch.Generator(
        device=cuda_device).manual_seed(210), device=cuda_device))
    bt.reset_launch_counts()
    W, outs, _ = _dense_slice(W0, n_steps, cuda_device)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert {k: counts[k] for k in DENSE_OPS} == dict(
        dense_event_mv=2 * n_steps, dense_event_mm=n_steps,
        dense_stdp_pre=n_steps, dense_stdp_post=n_steps,
        event_row_count=n_steps)
    with card.twins_on_card(ops):
        W_t, outs_t, bnds = _dense_slice(W0, n_steps, cuda_device, True)
    assert torch.equal(W.data, W_t.data)
    for got, want, bound in zip(outs, outs_t, bnds):
        for a, b, c in zip(got[:3], want[:3], bound):
            card.within(a, b, c, 'dense slice product')
        for a, b in zip(got[3:], want[3:]):
            assert torch.equal(a, b), 'encoder counts'
    del outs, outs_t, bnds, W_t
    g = torch.Generator(device=cuda_device).manual_seed(231)
    x = torch.nan_to_num(_dense_spikes(np.random.default_rng(231), (n,),
                                       0.01, 'float', cuda_device))
    ct = torch.randn(n, generator=g, device=cuda_device)
    grads = []
    for route in (card.twins_on_card([]), card.twins_on_card(ops)):
        data = W.data.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        with route:
            y = bt.Dense(data) @ bt.BinaryArray(xx)
            grads.append((y.detach(), *torch.autograd.grad(y, (data, xx),
                                                           ct)))
        del data
    (yk, gwk, gxk), (yt, gwt, gxt) = grads
    assert torch.equal(gwk, gwt) and torch.equal(gxk, gxt)
    card.within(yk, yt, bt.Dense(W.data.abs()) @ bt.BinaryArray(x), 'y')


def test_event_operands_route_through_k15_k16_on_card(cuda_device, gen):
    """``BinaryArray``, ``BitPackedBinary`` and ``CompactBinary`` against a
    tensor or a ``Dense`` (either side) each launch K15 or K16 once."""
    W = torch.from_numpy(gen.normal(size=(300, 200)).astype(F32)).to(
        cuda_device)
    D = bt.Dense(W)
    s = torch.from_numpy(gen.random(300) < 0.1).to(cuda_device)
    u = torch.from_numpy(gen.random(200) < 0.1).to(cuda_device)
    S = torch.from_numpy(gen.random((4, 300)) < 0.1).to(cuda_device)
    U = torch.from_numpy(gen.random((200, 4)) < 0.1).to(cuda_device)
    for expr, name in (
            (lambda: bt.BinaryArray(s) @ W, 'dense_event_mv'),
            (lambda: W @ bt.BinaryArray(u), 'dense_event_mv'),
            (lambda: bt.BinaryArray(S) @ W, 'dense_event_mm'),
            (lambda: W @ bt.BinaryArray(U), 'dense_event_mm'),
            (lambda: bt.BitPackedBinary(s) @ W, 'dense_event_mv'),
            (lambda: W @ bt.BitPackedBinary(U), 'dense_event_mm'),
            (lambda: bt.CompactBinary.from_array(s) @ D, 'dense_event_mv'),
            (lambda: W @ bt.CompactBinary.from_array(U), 'dense_event_mm'),
            (lambda: D @ bt.BinaryArray(u), 'dense_event_mv'),
            (lambda: bt.BinaryArray(S) @ D, 'dense_event_mm')):
        bt.reset_launch_counts()
        expr()
        counts = bt.launch_counts()
        assert counts[name] == 1 and sum(counts.values()) == 1, counts


# -- K19 and the strategies of einet_pallas_sim ---------------------------------------

@pytest.mark.parametrize('table_dtype', ['uint8', 'int32', 'uint8-40k'])
@pytest.mark.parametrize('n_act', [0, 1, 400, 4000, 10 ** 6])
def test_einet_dense_hits_kernel_vs_twin_and_k2(cuda_device, gen, n_act,
                                                table_dtype):
    """K19 equal to its twin and to K2's counts on a spike list with ids
    outside ``[0, num)``: 4k with a uint8 table and an int32 one (a
    multiplicity above 255), 40k with a uint8 table."""
    from brainevent_torch.models import sim
    table_dtype, _, size = table_dtype.partition('-')
    num = 40_000 if size == '40k' else 4000
    n_exc = int(0.8 * num)
    n_conn = 80 if table_dtype == 'uint8' else 300
    conn = gen.integers(0, num, (num, n_conn)).astype(np.int32)
    if table_dtype == 'int32':
        conn[5, :290] = 17                    # a multiplicity above 255
    net = bt.EINet(scale=num / 4000, n_conn=n_conn, conn_all=conn,
                   device=cuda_device)
    table = sim.dense_count_table(net)
    assert table.dtype == getattr(torch, table_dtype)
    ids = gen.permutation(num).astype(np.int32)
    ids[1:300:7] = -3
    ids[2:300:11] = num + 5
    ids = torch.from_numpy(ids).to(cuda_device)
    n_ids = torch.tensor([n_act], dtype=torch.int32, device=cuda_device)
    start = torch.from_numpy(gen.integers(0, 9, (2, num)).astype(
        np.int32)).to(cuda_device)
    before = sim.einet_dense_hits.launches
    got = sim.einet_dense_hits(ids, n_ids, table, n_exc, start.clone())
    want = sim.einet_dense_hits_twin(ids, n_ids, table, n_exc, start.clone())
    k2 = sc.event_count_scatter(ids, n_ids, net.conn_all, n_exc,
                                start.clone())
    torch.cuda.synchronize()
    assert sim.einet_dense_hits.launches == before + 1
    assert torch.equal(got, want) and torch.equal(got, k2)


# -- K21's table instance: the dense strategy in one launch ---------------------------

def _k19_loop(net, state, n, table, inp=20.0):
    """The loop of K1 and K19 on the card from *state* (the dense route
    the table instance replaced, 2n + 1 launches)."""
    bt.reset_launch_counts()
    out = _fields(net._simulate(state, net.times(n), inp,
                                step_op=nw.einet_step, table=table))
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert (counts['einet_step'], counts['einet_dense_hits']) == (n + 1, n)
    return out


def _table_npts(net, device, dtype):
    """The NPT instances of the table source whose grid fits *net*."""
    return [k for k in nw.SIM_SOURCE_NPT[dtype]
            if -(-net.num // (k * nw.SIM_BLOCK))
            <= nw.einet_sim_max_blocks(device, k, dtype)]


@pytest.mark.parametrize('net_kw', [dict(scale=1.0, coba=True),
                                    dict(scale=1.0, coba=False),
                                    dict(scale=10.0, coba=True)],
                         ids=['coba-4k', 'cuba-4k', 'coba-40k'])
def test_k21_table_bitwise_k1_k19_loop(cuda_device, net_kw):
    """The table instance, each NPT whose grid fits with each walk (each
    block its own rows, or the whole grid) and the package's choice
    twice, bitwise the K1 + K19 loop and the twin loop over 2,000 steps,
    in one launch each."""
    from brainevent_torch.models import sim
    net = bt.EINet(device=cuda_device, **net_kw)
    state = net.init_state()
    table = sim.dense_count_table(net)
    assert nw.table_piece_bytes(table) == 16
    # the 4 KB rows of 4k are walked by block, the 40 KB rows of 40k by grid
    assert nw.table_grid_walk(table) == (net.num == 40_000)
    want = _k19_loop(net, state, 2000, table)
    twin = _fields(net._simulate(state, net.times(2000), 20.0,
                                 step_op=nw.einet_step_twin,
                                 scatter_op=sc.event_count_scatter_twin))
    _bitwise(want, twin)
    npts = _table_npts(net, cuda_device, table.dtype)
    assert npts[0] == nw.einet_sim_grid(net.num, cuda_device, table.dtype)[0]
    for npt in npts:
        for walk in (False, True):
            _bitwise(_k21(net, state, 2000, table=table, npt=npt,
                          grid_walk=walk), want)
    for _ in range(2):
        card.run_strategy(net, state, 2000, 'dense', want)


@pytest.mark.parametrize('case', ['uint8-1000', 'uint8-1010', 'int32-4000',
                                  'int32-1010'])
def test_k21_table_pieces_and_int32(cuda_device, case):
    """Rows of num * itemsize bytes that are not a multiple of 16 (4-byte
    and one-entry pieces), and int32 tables (a multiplicity above 255):
    bitwise the K1 + K19 loop over 2,000 steps, each NPT that fits, and
    the dense strategy in one launch."""
    from brainevent_torch.models import sim
    dtype, num = case.split('-')
    num = int(num)
    rng = np.random.default_rng(num)
    n_conn = 300 if dtype == 'int32' else 80
    conn = rng.integers(0, num, (num, n_conn)).astype(np.int32)
    if dtype == 'int32':
        conn[5, :290] = 17
    net = bt.EINet(scale=num / 4000, n_conn=n_conn, conn_all=conn,
                   device=cuda_device)
    assert net.num == num
    table = sim.dense_count_table(net)
    assert table.dtype == getattr(torch, dtype)
    assert nw.table_piece_bytes(table) == {
        'uint8-1000': 4, 'uint8-1010': 1, 'int32-4000': 16,
        'int32-1010': 4}[case]
    state = net.init_state()
    want = _k19_loop(net, state, 2000, table)
    for npt in _table_npts(net, cuda_device, table.dtype):
        for walk in (False, True):
            _bitwise(_k21(net, state, 2000, table=table, npt=npt,
                          grid_walk=walk), want)
    card.run_strategy(net, state, 2000, 'dense', want)


@pytest.mark.parametrize('coba', [True, False], ids=['coba', 'cuba'])
def test_k21_table_all_fire_burst(cuda_device, coba):
    """Every neuron fires at the first step: each block walks 256 table
    rows at once (or the grid all 4,000); bitwise the K1 + K19 loop,
    twice each."""
    from brainevent_torch.models import sim
    net = bt.EINet(scale=1.0, coba=coba, seed=3, device=cuda_device)
    s = net.init_state()
    v = net.params.v_th + torch.rand(net.num, device=cuda_device)
    state = s._replace(neurons=s.neurons._replace(
        v=v, t_last=torch.full_like(v, -1e7)))
    table = sim.dense_count_table(net)
    want = _k19_loop(net, state, 200, table, 500.0)
    for _ in range(2):
        for walk in (False, True):
            _bitwise(_k21(net, state, 200, 500.0, table=table,
                          grid_walk=walk), want)
    assert int(_k21(net, state, 1, 500.0, table=table)[4].min()) == 1


def test_k21_table_refuses_a_bad_piece(cuda_device):
    """A table piece that does not divide the row is refused by the C
    entry point, and the launch is not counted."""
    from brainevent_torch.models import sim
    net = bt.EINet(scale=0.25, device=cuda_device)
    table = sim.dense_count_table(net)
    assert nw.table_piece_bytes(table) == 4            # 1000-byte rows
    before = nw.einet_sim.launches
    with pytest.raises(bt.KernelExecutionError):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(nw, 'table_piece_bytes', lambda table: 16)
            _k21(net, net.init_state(), 5, table=table)
    assert nw.einet_sim.launches == before


def test_dense_above_the_table_capacity_runs_k1_k19(cuda_device):
    """The dense strategy's route above the table instance's capacity, K1 +
    K19 (``EINet._simulate`` with K1 as its step op and the table; no K21
    or K2), bitwise mxu3."""
    from brainevent_torch.models import sim
    net = bt.EINet(scale=1.0, device=cuda_device)
    state = net.init_state()
    ref = bt.einet_pallas_sim(net, state, 300, strategy='mxu3')
    _bitwise(_k19_loop(net, state, 300, sim.dense_count_table(net)), ref)
    counts = bt.launch_counts()
    assert counts['einet_sim'] == counts['event_count_scatter'] == 0


def test_k21_table_capacity_exceeds_the_largest_table(cuda_device):
    """Each table instance's capacity, from the largest NPT built for its
    dtype, exceeds the neurons of the largest table the card's memory
    holds, so the dense strategy always runs in one launch; the capacity
    is that instance's co-resident grid."""
    import math
    total = torch.cuda.get_device_properties(cuda_device).total_memory
    for dtype in (torch.uint8, torch.int32):
        npt = nw.SIM_SOURCE_NPT[dtype][-1]
        cap = nw.einet_sim_capacity(cuda_device, dtype)
        assert cap == (
            nw.einet_sim_max_blocks(cuda_device, npt, dtype) * 256 * npt)
        item = torch.empty((), dtype=dtype).element_size()
        assert cap > math.isqrt(total // item)


@pytest.mark.parametrize('strategy', ['dense', 'chain', 'mxu', 'mxu2', 'mxu4',
                                      'mxu5', 'mxu6'])
def test_strategies_match_mxu3_on_card(cuda_device, strategy):
    n_steps = 2000
    net = bt.EINet(scale=1.0, coba=True, device=cuda_device)
    state = net.init_state()
    ref = bt.einet_pallas_sim(net, state, n_steps, strategy='mxu3')
    card.run_strategy(net, state, n_steps, strategy, ref)


# -- the dtypes the public entries take (ops/operand.py) -------------------------------
# the matrix is tests/_torch_card.py's; each part runs here on its own

def _c8_gen(device):
    return torch.Generator(device=device).manual_seed(28)


def test_spike_dtypes_on_card_equal_bool_spikes(cuda_device):
    assert card.c8_spike_dtypes(cuda_device, _c8_gen(cuda_device)) == (
        13 * len(card.C8_SPIKE_DTYPES))


def test_half_weights_on_card_within_one_ulp(cuda_device):
    worst = card.c8_half_weights(cuda_device, _c8_gen(cuda_device))
    assert set(worst) == {'torch.float16', 'torch.bfloat16'}


def test_float64_weights_on_card_are_refused(cuda_device):
    # C10 closed: float64 weights launch the double instances and are held
    # against the float64 twins (the name is the earlier test's)
    n, _ = card.c8_float64_weights(cuda_device, _c8_gen(cuda_device))
    assert n == 10


def test_float64_float_products_on_card(cuda_device):
    n, _ = card.c10_float_products(cuda_device, _c8_gen(cuda_device))
    assert n == 5


# -- the multi-device layer: K20, K11/K12 with row0, ShardedEINet (world 1) ----------

@pytest.mark.parametrize('scale', [1.0, 100.0], ids=['4k', '400k'])
@pytest.mark.parametrize('n_act', [0, 1, 40, 4000])
def test_k20_shards_vs_twin_and_k2(cuda_device, gen, n_act, scale):
    """K20 at world size 1 and over four shards in one process (row0 = r *
    n_loc): each partial bitwise its twin, the shards summed and the
    shard-major buffer bitwise K2; ``mega_local_counts`` on the four
    shards, one K20 launch each, summed bitwise K2."""
    net = bt.EINet(scale=scale, device=cuda_device)
    ids = torch.from_numpy(gen.permutation(net.num).astype(np.int32)).to(
        cuda_device)
    n_ids = torch.tensor([n_act], dtype=torch.int32, device=cuda_device)
    for n_dev in (1, 4):
        assert card.k20_vs_k2(net, ids, n_ids, cuda_device, n_dev) == 0.0
    assert card.local_counts_vs_k2(net, ids, n_ids, cuda_device) == 4


def test_k20_exact_at_in_degree_300(cuda_device):
    """Every neuron spiking into a target of in-degree 300 a class (the
    JAX mega-kernel refuses above 255): the counts equal the in-degrees,
    and the four shards bitwise their twins and K2."""
    from brainevent_torch.parallel import mega
    net = card.indegree_net(cuda_device)
    ids = torch.arange(net.num, dtype=torch.int32, device=cuda_device)
    n_ids = torch.tensor([net.num], dtype=torch.int32, device=cuda_device)
    assert card.k20_vs_k2(net, ids, n_ids, cuda_device) == 0.0
    counts = mega.mega_counts(ids, n_ids, net.conn_all, 0, net.n_exc,
                              torch.zeros(1, 2, net.num, dtype=torch.int32,
                                          device=cuda_device))
    deg = torch.stack([
        torch.bincount(net.conn_all[:3200].reshape(-1).long(), minlength=4000),
        torch.bincount(net.conn_all[3200:].reshape(-1).long(),
                       minlength=4000)]).to(torch.int32)
    assert torch.equal(counts[0], deg) and int(deg[:, 17].min()) >= 300


@pytest.mark.parametrize('n_dev', [1, 4])
@pytest.mark.parametrize('scale', [1.0, 100.0], ids=['4k', '400k'])
def test_k22_bitwise_k1_memset_k20(cuda_device, scale, n_dev):
    """K22 on random step states, each parity, fold and step, at world
    size 1 and over four shards in one process (row0 = r * n_loc): the
    state and both parities of the partials bitwise its twin and one K1
    step, a memset and K20; the shards summed bitwise K2."""
    net = bt.EINet(scale=scale, device=cuda_device)
    assert card.k22_vs_k1_k20(net, cuda_device, n_dev, seed=7) == 0.0


@pytest.mark.parametrize('corder', [True, False], ids=['gather', 'scatter'])
def test_jitc_row0_halves_match_whole_walk(cuda_device, gen, corder):
    from brainevent_torch.jitc import pallas_kernels as jk
    n_rows, n_cols, half = 6400, 8000, 3200
    kw = dict(law=1, a=0.6, b=float(F32(0.06)), seed=42, cl=200,
              logical_cols=n_cols)
    halves = [jk.walk_plan_setup(42, 200, half, n_cols, 2000,
                                 device=cuda_device, row0=r0)
              for r0 in (0, half)]
    s_all, q_all, _ = jk.walk_plan_setup(42, 200, n_rows, n_cols, 2000,
                                         device=cuda_device)
    assert torch.equal(torch.cat([h[0] for h in halves]), s_all)
    assert torch.equal(torch.cat([h[1] for h in halves]), q_all)
    x = torch.from_numpy(gen.standard_normal(
        n_cols if corder else n_rows).astype(F32)).to(cuda_device)
    whole = jk.jitc_walk_mv(None, None, x, n_rows=n_rows, n_cols=n_cols,
                            corder=corder, event=False, **kw)
    parts = []
    for i in range(2):
        xi = x if corder else x[i * half:(i + 1) * half].contiguous()
        parts.append(jk.jitc_walk_mv(*halves[i][:2], xi, n_rows=half,
                                     n_cols=n_cols, corder=corder,
                                     event=False, row0=i * half, **kw))
    torch.cuda.synchronize()
    if corder:
        assert torch.equal(torch.cat(parts), whole)
    else:
        bound = jk.jitc_walk_mv(None, None, x.abs(), n_rows=n_rows,
                                n_cols=n_cols, corder=False, event=False,
                                **dict(kw, law=0, a=0.6 + 6 * 0.06, b=0.0))
        assert bool(((parts[0] + parts[1] - whole).abs()
                     <= 1e-5 * bound).all())


@pytest.fixture(scope='module')
def world1_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the CUDA kernels have no CPU form')
    mesh = card.neuron_mesh_world1(torch.device('cuda'),
                                   tmp_path_factory.mktemp('pg'))
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize('scale', [1.0, 100.0], ids=['4k', '400k'])
@pytest.mark.parametrize('propagate', ['scatter', 'mxu6'])
def test_sharded_einet_on_card_bitwise_einet(cuda_device, world1_mesh,
                                             propagate, scale):
    """``ShardedEINet`` at world size 1 (NCCL) over 2,000 steps: all five
    fields bitwise ``EINet``; K22 2,001 launches and K1, K2, K20 none;
    exactly one ``reduce_scatter_tensor`` of ``2 * num * 4`` bytes a step
    and no other collective. The parent's route (K1, a memset and K20 a
    step) bitwise too, with K1 2,001 and K20 2,000 launches."""
    import dataclasses
    from brainevent_torch.parallel import ShardedEINet
    n_steps = 2000
    net = bt.EINet(scale=scale, coba=True, device=cuda_device)
    state = net.init_state()
    want = _fields(net.run(n_steps, state=state))
    snet = ShardedEINet.from_einet(net, world1_mesh)
    if propagate != 'scatter':
        snet = dataclasses.replace(snet, propagate=propagate)
    bt.reset_launch_counts()
    with CollectiveLog() as log:
        out = snet.run(n_steps, 20.0, state=snet.init_state_from(state))
        torch.cuda.synchronize()
    for x, y in zip(out, want):
        assert torch.equal(x.to_local(), y)
    counts = bt.launch_counts()
    assert counts['einet_shard_step'] == n_steps + 1
    assert counts['einet_step'] == counts['mega_counts'] == 0
    assert counts['event_scatter_float'] == counts['event_count_scatter'] == 0
    assert log.calls == [('reduce_scatter_tensor', 2 * net.num * 4)] * n_steps
    bt.reset_launch_counts()
    with CollectiveLog() as log:
        out = card.parent_sharded_run(snet, snet.init_state_from(state),
                                      n_steps)
        torch.cuda.synchronize()
    _bitwise(out, want)
    counts = bt.launch_counts()
    assert (counts['einet_step'], counts['mega_counts'],
            counts['einet_shard_step']) == (n_steps + 1, n_steps, 0)
    assert len(log.calls) == n_steps


def test_sharded_ops_on_card_match_single_device(cuda_device, world1_mesh):
    """The sharded ops at world size 1 against the single-device entries:
    ``sharded_binary_fcnmv`` (both weights, both directions, ``psum`` and
    ``psum_scatter``; 20k x 20k, 80 a row), the four CSR wrappers both ways
    and a weight gradient (4000 x 3000 at 2%), bitwise, K5's and K8's
    float atomics within ``1e-5 * sum|w x|``; K11/K12 at the 80k E
    projection of ``JITCNet(scale=20)`` (64,000 x 80,000) in two halves,
    ``row0`` 0 and 32,000: the plan halves and the gathers bitwise the
    whole walk, the scatter's within ``1e-5 * sum|w x|``;
    ``sharded_jitmv`` bitwise ``jitnmv``."""
    from brainevent_torch import parallel as par
    from brainevent_torch._misc import _initialize_conn_length
    from brainevent_torch.jitc import pallas_kernels as jk
    mesh, device = world1_mesh, cuda_device
    gen = torch.Generator(device=device).manual_seed(31)
    n = m = 20_000
    idx = torch.randint(0, m, (n, 80), generator=gen, device=device,
                        dtype=torch.int32)
    w_ell = torch.randn(n, 80, generator=gen, device=device)
    spk = {True: torch.rand(n, generator=gen, device=device) < 0.01,
           False: torch.rand(m, generator=gen, device=device) < 0.01}
    for homo in (True, False):
        w = w_ell[0, :1] if homo else w_ell
        for transpose in (True, False):
            for reduce in (('psum', 'psum_scatter') if transpose
                           else ('psum',)):
                s = spk[transpose]
                got = par.sharded_binary_fcnmv(
                    w, idx, s, mesh=mesh, shape=(n, m), transpose=transpose,
                    reduce=reduce).to_local()
                want = bt.binary_fcnmv(w, idx, s, shape=(n, m),
                                       transpose=transpose)
                if transpose and not homo:          # K5's float atomics
                    card.within(got, want, bt.binary_fcnmv(
                        w.abs(), idx, s, shape=(n, m), transpose=True))
                else:
                    assert torch.equal(got, want), (homo, transpose, reduce)
    cm, ck = 4000, 3000
    on = torch.rand(cm, ck, generator=gen, device=device) < 0.02
    A = bt.CSR.fromdense(torch.where(on, torch.randn(
        cm, ck, generator=gen, device=device), 0.0))
    args, shape = (A.indices, A.indptr), A.shape
    plan = par.balance_csr_shards(A.indices, A.indptr, 1, shape=shape)
    x = {r: torch.randn(r, generator=gen, device=device) for r in (cm, ck)}
    X = {r: torch.randn(r, 16, generator=gen, device=device)
         for r in (cm, ck)}
    for name, single, sharded, op_of in (
            ('binary_csrmv', bt.binary_csrmv, par.sharded_binary_csrmv,
             lambda r: x[r] > 1.0),
            ('csrmv', bt.csrmv, par.sharded_csrmv, lambda r: x[r]),
            ('binary_csrmm', bt.binary_csrmm, par.sharded_binary_csrmm,
             lambda r: X[r] > 1.0),
            ('csrmm', bt.csrmm, par.sharded_csrmm, lambda r: X[r])):
        for transpose in (True, False):
            o = op_of(cm if transpose else ck)
            got = sharded(A.data, *args, o, mesh=mesh, shape=shape,
                          transpose=transpose, plan=plan).to_local()
            want = single(A.data, *args, o, shape=shape, transpose=transpose)
            if transpose and got.dim() == 1:        # K8's float atomics
                card.within(got, want, single(
                    A.data.abs(), *args, o.abs() if o.is_floating_point()
                    else o, shape=shape, transpose=True), name)
            else:
                assert torch.equal(got, want), (name, transpose)
    cot = torch.randn(ck, generator=gen, device=device)
    s_pre = torch.rand(cm, generator=gen, device=device) < 0.01
    grads = []
    for fn in (lambda w: par.sharded_binary_csrmv(
            w, *args, s_pre, mesh=mesh, shape=shape, plan=plan).to_local(),
            lambda w: bt.binary_csrmv(w, *args, s_pre, shape=shape,
                                      transpose=True)):
        wg = A.data.clone().requires_grad_(True)
        (fn(wg) * cot).sum().backward()
        grads.append(wg.grad)
    assert torch.equal(*grads), 'sharded CSR weight gradient (K9)'
    n_rows, n_cols = 64_000, 80_000
    kw = dict(law=1, a=0.6, b=float(F32(0.06)), seed=42,
              cl=_initialize_conn_length(80 / n_cols), logical_cols=n_cols)
    chunk, half = -(-n_cols // 4), n_rows // 2
    s_all, q_all, _ = jk.walk_plan_setup(42, kw['cl'], n_rows, n_cols, chunk,
                                         device=device)
    halves = [jk.walk_plan_setup(42, kw['cl'], half, n_cols, chunk,
                                 device=device, row0=r0)
              for r0 in (0, half)]
    assert torch.equal(torch.cat([h[0] for h in halves]), s_all)
    assert torch.equal(torch.cat([h[1] for h in halves]), q_all)
    v = torch.randn(n_cols, generator=gen, device=device)
    whole = jk.jitc_walk_mv(None, None, v, n_rows=n_rows, n_cols=n_cols,
                            corder=True, event=False, **kw)
    for own in (True, False):
        parts = [jk.jitc_walk_mv(*((None, None) if own else halves[i][:2]), v,
                                 n_rows=half, n_cols=n_cols, corder=True,
                                 event=False, row0=i * half, **kw)
                 for i in range(2)]
        assert torch.equal(torch.cat(parts), whole), own
    s = torch.rand(n_rows, generator=gen, device=device) < 0.002
    whole = jk.jitc_walk_mv(None, None, s, n_rows=n_rows, n_cols=n_cols,
                            corder=False, event=True, **kw)
    parts = sum(jk.jitc_walk_mv(None, None, s[i * half:(i + 1) * half],
                                n_rows=half, n_cols=n_cols, corder=False,
                                event=True, row0=i * half, **kw)
                for i in range(2))
    visits = jk.jitc_walk_mv(None, None, s, n_rows=n_rows, n_cols=n_cols,
                             corder=False, event=True,
                             **dict(kw, law=0, a=1.0, b=0.0))
    card.within(parts, whole, visits * (0.6 + 6 * 0.06), 'K12 row0 scatter')
    got = par.sharded_jitmv('n', (0.6, 0.06), 80 / n_cols, v, 42, mesh=mesh,
                            shape=(n_rows, n_cols)).to_local()
    assert torch.equal(got, bt.jitnmv(0.6, 0.06, 80 / n_cols, v, 42,
                                      shape=(n_rows, n_cols)))
