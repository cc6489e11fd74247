# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Time brainevent_torch's CUDA kernels on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card::

    python3 scripts/kernel_times.py
    python3 scripts/kernel_times.py --tree DIR [--parts k10,jitc,...]

With no arguments it times each kernel, K1-K24 and K21's table instance,
at the shapes of the path that launches it, and prints two JSON lines:
``{"kernels": [...]}``, one entry a kernel (its device ms a call, its
twin's ms, the least time of the work the call must do and what bounds
it, and the ms of one PyTorch call computing the same function where one
exists), then ``{"details": {...}}``, what each timer measured beside its
kernel (the routes a kernel replaced, its variants and shapes). The card
tests (``tests/test_torch_cuda.py``, ``tests/test_torch_microcircuit.py``)
check what is timed here; this script checks only that the runs it
compares compute the same bits.

With ``--tree DIR`` it times the ``brainevent_torch`` of the checkout at
DIR by this file's code (:func:`time_tree`), so that two versions are
timed by the same code on one card: run it for each in turns (A, B, B,
A). ``--parts`` picks some of :data:`TREE_PARTS`.

A kernel's device ms: calls queued back to back behind a sleep kernel,
timed with CUDA events (:func:`device_ms`), so that the host's launch
cost does not enter. Least time: ``least_seconds`` of
``benchmark_torch/harness/roofline.py`` (the H100's published peaks).
Profiled windows: ``profile`` of ``benchmark_torch/harness/trace.py``,
whose busy time is the union of the device operations' intervals.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
F32 = np.float32
_START = time.perf_counter()

EI_STEPS = 2000             # one K21 launch, timed on device
# (label, EINet scale, steps timed, warm-up steps) of the COBA runs
EI_TIMES = (('4k', 1.0, 100_000, 1000), ('400k', 100.0, 5000, 200))
GRAPH_STEPS = 2000          # the K1 + K2 loop captured in one CUDA graph
CLUSTER_FLOORS = (2, 4, 8, 16)      # blocks of the bare cluster barrier loop
BIG = dict(n_in=100, n_hidden=100_000, n_out=10, n_conn=100)
# the reference grid's largest CSR event-SpMV shape, (10k, 10k, 10%), the
# csrmm cell (10k, 10k, 1%, B = 256) and the CSR slice's B
CSR_N, CSR_DENSITY = 10_000, 0.1
MM_N, MM_DENSITY, MM_B = 10_000, 0.01, 256
SLICE_B = 16
# BENCH_PRIMS_r05.json's JITC rows: (5120, 5120) at 1%, the normal law
JITC_N, JITC_PROB, JITC_SEED = 5120, 0.01, 2024
JITC_NORMAL = (1, 0.6, 0.06)        # law code, a, b
JITC_STEPS = 2000
JITC_SCALES = {'80k': 20.0, '4k': 1.0}          # JITCNet(scale=...)
# operations per visit of a stream (the walk's draw, bound and loop, plus
# the weight law: none, Acklam's normal, the uniform hash) and per stream
# set up (its seed hash and ~2 rejection rounds of 2 draws): estimates
# from the code of csrc/light_rng.cuh, 32-bit integer and float32 work
VISIT_OPS = {0: 12, 1: 12 + 60, 2: 12 + 20}
SETUP_OPS = 54
# JAX dense/binary.py's benchmark sizes: the (10k, 10k) matvec at 1%, the
# matmul at B = 128; the encoders' (10k, 128)
DENSE_N, DENSE_RATE, DENSE_B = 10_000, 0.01, 128
# (label, EINet scale, steps timed, warm-up steps) of the dense strategy
DENSE_TIMES = (('4k', 1.0, 100_000, 1000), ('40k', 10.0, 20_000, 1000))
DENSE_TIME_WARM = 1000
# EINet scales of the walk sweep (6k-30k neurons): between the 4k table,
# which the L2 cache holds, and the 40k one
WALK_SCALES = (1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 7.5)
SHARD_NETS = (('4k', 1.0), ('400k', 100.0))
MC_SCALE = 1.0      # the microcircuit: 77,169 neurons, 2.99e8 synapses
MC_WARM, MC_STEPS = 1000, 2000      # its timed launch, after the warm-up
HPC_SCALE = 10.0    # the HPC benchmark network: 112,500 neurons, 1.27e9 synapses
HPC_WARM, HPC_STEPS = 1000, 1000    # its timed launch, after the warm-up
TREE_PARTS = ('k10', 'jitc', 'k15', 'train', 'dense', 'ei', 'ei_dense')


def phase(name):
    """Print a timer's header with the seconds since the script started."""
    print(f'== {name} [{time.perf_counter() - _START:.1f} s]', flush=True)


def check(ok, what):
    """Stop the run when *ok* is false (unlike assert, kept under -O)."""
    if not ok:
        raise SystemExit(f'kernel_times: FAILED: {what}')


def device_ms(fn, reps):
    """Device time of one call of *fn*: *reps* calls are queued behind a
    sleep kernel, so that they run back to back on the card whatever the
    host's launch cost, and timed with a pair of CUDA events."""
    fn()
    torch.cuda.synchronize()
    cycles = int(2e8)                       # ~0.1 s at the H100's clock
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()              # the sleep outlasted the enqueue
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise RuntimeError('could not queue the calls behind the sleep kernel')


def host_ms(fn, reps):
    """Wall time of one call of *fn* as the host issues it, over *reps*
    calls and a final synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profiled(fn, device, n_steps):
    """*fn* (*n_steps* steps) in one profiled window: device busy and wall
    us a step, the idle share and the operations that took the most
    device time (``[name, seconds]``)."""
    from benchmark_torch.harness.trace import profile
    _, trace = profile(fn, device)
    return dict(kernel_us=trace.busy_s / n_steps * 1e6,
                wall_us=trace.window_s / n_steps * 1e6,
                idle=1 - trace.busy_s / trace.window_s, top=trace.device_ops)


def same_bits(got, want):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(got, want))


# -- the EI network: K21, and K1 + K2 above its capacity ------------------------

def fields(state):
    """The five arrays of an ``EINetState``, in ``einet_pallas_sim``'s order."""
    return (state.neurons.v, state.neurons.t_last, state.g_e, state.g_i,
            state.spike_count)


def k1k2_ops():
    """``EINet._simulate``'s keywords for the loop of K1 and K2."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
    return dict(step_op=nw.einet_step, scatter_op=sc.event_count_scatter)


def time_run(net, n_steps, warm, strategy='auto'):
    """us/step (host clock) of ``einet_pallas_sim`` over *n_steps* from the
    state *warm* steps in; the rate in Hz and the outputs."""
    import brainevent_torch as bt
    state = bt.einet_pallas_sim(net, net.init_state(), warm,
                                strategy=strategy)
    state = bt.EINetState(bt.LIFRefState(state[0], state[1]), *state[2:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bt.einet_pallas_sim(net, state, n_steps, strategy=strategy)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = float(out[4].float().mean()) / (n_steps * net.dt * 1e-3)
    return dt / n_steps * 1e6, rate, out


def time_routes(net, n_steps, warm):
    """COBA us/step (host clock) through K21 and through the K1 + K2 loop
    from the state *warm* K21 steps in, in turns K21, K1 + K2, K1 + K2,
    K21, each bitwise the other route. Returns ``({route: [us, us]}, rate,
    K21's final state)``."""
    import brainevent_torch as bt
    state = net.run(warm)
    times = net.times(warm + n_steps)[warm:]
    runs, outs = {'K21': [], 'K1 + K2': []}, {}
    for route in ('K21', 'K1 + K2', 'K1 + K2', 'K21'):
        kw = {} if route == 'K21' else k1k2_ops()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net._simulate(state, times, 20.0, **kw)
        torch.cuda.synchronize()
        runs[route].append((time.perf_counter() - t0) / n_steps * 1e6)
        outs[route] = fields(out)
    check(same_bits(outs['K21'], outs['K1 + K2']), ('timed runs', net.num))
    final = outs['K21']
    rate = float(final[4].float().mean() - state.spike_count.float().mean()
                 ) / (n_steps * net.dt * 1e-3)
    return runs, rate, bt.EINetState(bt.LIFRefState(*final[:2]), *final[2:])


def graph_us_per_step(net, state, replays):
    """The K1 + K2 loop of :data:`GRAPH_STEPS` steps from *state* captured
    in one ``torch.cuda.CUDAGraph``: us per step on replay (host clock),
    a yardstick of the two-kernel form without a launch path; the replay
    bitwise an eager run of the same loop."""
    times = net.times(GRAPH_STEPS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fields(net._simulate(state, times, 20.0, **k1k2_ops()))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = net._simulate(state, times, 20.0, **k1k2_ops())
    graph.replay()
    torch.cuda.synchronize()
    check(same_bits(fields(captured), eager), 'CUDA graph replay')
    t0 = time.perf_counter()
    for _ in range(replays):
        graph.replay()
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / (replays * GRAPH_STEPS) * 1e6
    del graph
    return us


def sim_device_ms(net, state, n_steps, start, **kw):
    """Device ms of one K21 launch of *n_steps* from *state*, *start*
    steps into its run, so that the clock goes on from the state's
    ``t_last`` (CUDA events around the launch; its copy of the state made
    beforehand), with the instance, grid and table of *kw*. Returns the
    ms and the outputs."""
    from brainevent_torch.models import networks as nw
    bufs = [x.clone() for x in fields(state)]
    times = torch.tensor(net.times(start + n_steps)[start:],
                         dtype=torch.float32, device=bufs[0].device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    nw.einet_sim.cuda(nw.einet_sim, *bufs, net.conn_all, times,
                      net.step_params(), net.n_exc, **kw)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), bufs


def barrier_ms(net, n_syncs, device):
    """Device ms of K21's bare barrier loop: *n_syncs* grid barriers on the
    grid K21 runs for *net*, nothing else."""
    import ctypes
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import cuda_build
    from brainevent_torch.ops.core import cuda_stream
    _, blocks = nw.einet_sim_grid(net.num, device)
    fn = cuda_build.function('einet_sim_barriers_launch', [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    err = fn(n_syncs, blocks, device.index or 0, cuda_stream(device))
    b.record()
    torch.cuda.synchronize()
    check(err == 0, ('barrier loop', err))
    return a.elapsed_time(b)


def cluster_barrier_ms(n_syncs, blocks, share, npt, n_conn, device):
    """Device ms of *n_syncs* bare ``cluster.sync()`` barriers on one
    cluster of *blocks* blocks, each shaped as a block of K21's cluster
    instance *npt* for *share* neurons of *n_conn* targets (its threads,
    and its shared memory, so that one block takes an SM)."""
    import ctypes
    from brainevent_torch.ops import cuda_build
    from brainevent_torch.ops.core import cuda_stream
    fn = cuda_build.function('einet_sim_cluster_barriers_launch', [
        ctypes.c_int] * 5 + [ctypes.c_void_p])
    args = (blocks, -(-share // (32 * npt)) * 32, 4 * share * (n_conn + 4),
            device.index or 0, cuda_stream(device))
    check(fn(10, *args) == 0, ('cluster barrier loop', blocks))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    err = fn(n_syncs, *args)
    b.record()
    torch.cuda.synchronize()
    check(err == 0, ('cluster barrier loop', blocks, err))
    return a.elapsed_time(b)


def time_ei(nets, device):
    """COBA at :data:`EI_TIMES`: K21 beside the K1 + K2 loop (in turns),
    its CUDA-graph capture, K21's device us/step by grid instance (every
    NPT whose grid fits) and its bare barrier loop; where the package runs
    K21's cluster instance, that instance's device us/step and the bare
    cluster barrier loop at :data:`CLUSTER_FLOORS`; one K21 launch of
    :data:`EI_STEPS` steps. Returns the results and each run's final
    state."""
    from brainevent_torch.models import networks as nw
    res, finals = {}, {}
    for label, _, n_steps, warm in EI_TIMES:
        net = nets[label]
        runs, rate, final = time_routes(net, n_steps, warm)
        start = warm + n_steps
        finals[label] = (start, fields(final))
        graph_us = graph_us_per_step(net, final,
                                     max(1, round(n_steps / GRAPH_STEPS)))
        npt, blocks = nw.einet_sim_grid(net.num, device)
        by_npt = {}
        for k in nw.SIM_NPT:
            if -(-net.num // (k * nw.SIM_BLOCK)) <= nw.einet_sim_max_blocks(
                    device, k):
                ms, _ = sim_device_ms(net, final, n_steps, start, npt=k)
                by_npt[k] = ms / n_steps * 1e3
        barrier_us = barrier_ms(net, n_steps, device) / n_steps * 1e3
        sim_ms, _ = sim_device_ms(net, final, EI_STEPS, start)
        n_conn = net.conn_all.shape[1]
        cluster = nw.einet_sim_cluster(net.num, n_conn, device)
        floors, cluster_us = {}, None
        if cluster is not None:
            ms, _ = sim_device_ms(net, final, n_steps, start)
            cluster_us = ms / n_steps * 1e3
            _, share, k = cluster
            for c in CLUSTER_FLOORS:
                floors[c] = cluster_barrier_ms(
                    n_steps, c, share, k, n_conn, device) / n_steps * 1e3
        res[label] = dict(us=runs, rate=rate, graph_us=graph_us, npt=npt,
                          blocks=blocks, device_us_by_npt=by_npt,
                          barrier_us=barrier_us, cluster=cluster,
                          cluster_us=cluster_us, cluster_barrier_us=floors,
                          sim_ms=sim_ms, steps=n_steps, start=start)
    return res, finals


def time_kernels(nets, finals, device):
    """K1 and K2 against their twins at the EI shapes: the state each
    timed run ended in, and the spike list of one more step from it."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
    out = {}
    for label, net in nets.items():
        p = net.step_params()
        steps_done, final = finals[label]
        num = net.num
        b = [x.clone() for x in final[:4]]
        b += [torch.zeros(2, num, dtype=torch.int32, device=device),
              final[4].clone(),
              torch.zeros(num, dtype=torch.int32, device=device),
              torch.zeros(2, dtype=torch.int32, device=device)]
        clock = [steps_done]

        def k1(op):
            t = float(F32(clock[0]) * F32(net.dt))
            op(*b, p, t, clock[0] & 1, True, True)
            clock[0] += 1

        reps, reps_twin = (500, 100) if num < 40_000 else (200, 20)
        res = dict(k1_ms=device_ms(lambda: k1(nw.einet_step), reps),
                   k1_host_ms=host_ms(lambda: k1(nw.einet_step), reps),
                   k1_twin_ms=host_ms(lambda: k1(nw.einet_step_twin),
                                      reps_twin))
        # K2 on the spike list of the last K1 step
        ids, parity = b[6], (clock[0] - 1) & 1
        n_ids = b[7][parity:parity + 1]
        n_events = int(n_ids)

        def k2(op):
            op(ids, n_ids, net.conn_all, net.n_exc, b[4])

        res.update(
            k2_ms=device_ms(lambda: k2(sc.event_count_scatter), reps),
            k2_host_ms=host_ms(lambda: k2(sc.event_count_scatter), reps),
            k2_twin_ms=host_ms(lambda: k2(sc.event_count_scatter_twin),
                               reps_twin))
        res['k2_library_ms'] = index_add_ms(net, ids, n_events, reps, device)
        res.update(k1_bytes=56 * num, k2_events=n_events,
                   k2_bytes=count_scatter_bytes(n_events,
                                                net.conn_all.shape[1]))
        out[label] = res
    return out


def index_add_ms(net, ids, n_events, reps, device):
    """The library yardstick of a hit-count scatter: one ``index_add_`` of
    ones into the two channels (E hits at [0, num), I at [num, 2 num))
    over the events' targets, gathered beforehand."""
    src = ids[:n_events].long()
    tgt = (net.conn_all[src].long() + net.num * (src >= net.n_exc).long()[
        :, None]).reshape(-1)
    ones = torch.ones(tgt.numel(), dtype=torch.int32, device=device)
    flat = torch.zeros(2 * net.num, dtype=torch.int32, device=device)
    return device_ms(lambda: flat.index_add_(0, tgt, ones), reps)


def count_scatter_bytes(n_events, n_conn):
    """The bytes an int32 hit-count scatter (K2, K20) must move for
    *n_events* spikes of *n_conn* targets each: the ids and the spiking
    rows read once, and a read and a write of each counter hit. The
    caller zeroes the counts in a launch of its own, so the rest of the
    buffer is not the kernel's traffic."""
    return 4 * n_events * (1 + n_conn) + 8 * n_events * n_conn


def time_k21(net, state, ei, device):
    """K21's line at COBA 4k: one launch of EI_STEPS steps from *state*
    (the timed run's end; device ms from :func:`time_ei`), its twin's ms
    on the same inputs (bitwise equal), and the work this run needs: the
    state read and written once, the step times, the rows of the neurons
    that spiked; 20 operations a neuron a step and one add a hit."""
    from brainevent_torch.models import networks as nw
    start = ei['start']
    _, got = sim_device_ms(net, state, EI_STEPS, start)
    want = [x.clone() for x in fields(state)]
    times = torch.tensor(net.times(start + EI_STEPS)[start:],
                         dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nw.einet_sim_twin(*want, net.conn_all, times, net.step_params(),
                      net.n_exc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(got, want), 'K21 line vs twin')
    new = got[4] - state.spike_count
    n_conn = net.conn_all.shape[1]
    return dict(ms=ei['sim_ms'], plain_ms=plain_ms,
                bytes=40 * net.num + 4 * EI_STEPS
                + 4 * n_conn * int((new > 0).sum()),
                ops=20 * net.num * EI_STEPS + n_conn * int(new.sum()))


# -- the training slice and binary_fcnmv (K3-K6) --------------------------------

def fcn_inputs(n, k, rate, gen, device):
    """``binary_fcnmv``'s operands as its users pass them: ``n`` rows of
    ``k`` targets, the homogeneous weight 0.5, bool spikes at *rate*."""
    idx = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32)
    s = torch.rand(n, generator=gen) < rate
    return [t.to(device) for t in (torch.tensor([0.5]), idx, s)]


def time_new_kernels(model, device):
    """K3 and K4 over the 100k x 100 model's plans (18% spikes), K5 and K6
    at 10M synapses and 0.1% and 1%: device ms a launch and the twin's ms
    a call; K4 without the row view, and the plans' row-order weight
    views apart; the library calls (``torch.sparse.mm``, one
    ``index_add_``) on the same inputs."""
    from brainevent_torch.fcn import binary as fb
    from brainevent_torch.ops import mxu_gather as mg
    gen = torch.Generator(device='cpu').manual_seed(11)
    n = model.n_hidden
    p = model.init_params()
    spk = (torch.rand(n, generator=gen) < 0.18).float().to(device)
    ct = torch.randn(n, generator=gen).to(device)
    # K3 reads the incoming plan's row-order weights and K4 the outgoing
    # plan's, each made once per train step
    fwd_w = model._plan_T.sort_rows(p.w_rec)
    bwd_w = model._plan.sort_rows(p.w_rec)
    w_sorted = model._plan.sort_data(p.w_rec)
    out = {}
    for name, op, args in (
            ('plan_gather_mv', mg.plan_gather_mv, (model._plan_T, fwd_w, spk)),
            ('plan_matvec_dw', mg.plan_matvec_dw_op,
             (model._plan, w_sorted, spk, ct, bwd_w))):
        out[name] = dict(ms=device_ms(lambda: op(*args), 50),
                         plain_ms=host_ms(lambda: op.twin(*args), 5))
    details = dict(plan_matvec_dw_without_view_ms=device_ms(
        lambda: mg.plan_matvec_dw_op(model._plan, w_sorted, spk, ct), 50))
    for label, plan in (('incoming', model._plan_T),
                        ('outgoing', model._plan)):
        details[f'{label}_row_view_ms'] = device_ms(
            lambda: plan.sort_rows(p.w_rec), 50)
    gen = torch.Generator(device='cpu').manual_seed(12)
    k = model.n_conn
    runs = {rate: fcn_inputs(n, k, rate, gen, device)
            for rate in (0.001, 0.01)}
    for rate, args in runs.items():
        for op in (fb.fcn_event_scatter, fb.fcn_event_gather):
            r = dict(ms=device_ms(lambda: op(*args, n), 100),
                     plain_ms=host_ms(lambda: op.twin(*args, n), 5))
            details[f'{op.name} {rate:.1%}'] = r
            if rate == 0.01:
                out[op.name] = dict(r)
    # the library calls on the same inputs, and the bytes each kernel moves
    nse = model._plan.nse
    src = torch.arange(n, device=device).repeat_interleave(k)
    tgt = model.rec_indices.reshape(-1).long()
    rec_csr = torch.sparse_coo_tensor(
        torch.stack([tgt, src]), p.w_rec.reshape(-1),
        (n, n)).coalesce().to_sparse_csr()
    out['plan_gather_mv'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(rec_csr, spk[:, None]),
                             50), bytes=8 * nse + 8 * n, ops=2 * nse)
    out['plan_matvec_dw'].update(bytes=12 * nse + 12 * n, ops=3 * nse)
    w, idx, s = runs[0.01]
    active = idx[s].reshape(-1).long()
    vals = w.expand(active.numel())
    y = torch.zeros(n, device=device)
    ell = torch.sparse_csr_tensor(
        torch.arange(0, n * k + 1, k, device=device), idx.reshape(-1).long(),
        w.expand(n * k).contiguous(), (n, n))
    # K5's function, y = W^T g(s) over the ELL table, as one call: the
    # transposed matrix (targets as rows) by the float spikes
    ell_t = torch.sparse_coo_tensor(
        torch.stack([idx.reshape(-1).long(), src]), w.expand(n * k),
        (n, n)).coalesce().to_sparse_csr()
    sf = s.float()[:, None]
    out['fcn_event_scatter'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(ell_t, sf), 100),
        bytes=n + 4 * active.numel() + 4 * n, ops=active.numel())
    # the active rows' targets gathered outside the timed call: not the
    # same function
    details['fcn_event_scatter_selected_index_add_ms'] = device_ms(
        lambda: y.index_add_(0, active, vals), 100)
    out['fcn_event_gather'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(ell, sf), 100),
        bytes=4 * n * k + 5 * n, ops=n * k)
    return out, details


def train_step_times(model, p, x):
    """Five train steps of *model* from *p* on the host clock (their
    median), then one profiled step: its busy and wall time, idle share
    and largest device operations."""
    import brainevent_torch as bt
    times = []
    q = p
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, loss = bt.train_step(model, q, x, 3, lr=1e-3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(loss)), loss)
    t = profiled(lambda: bt.train_step(model, q, x, 3, lr=1e-3), x.device, 1)
    return dict(ms=sorted(times)[2], times_ms=times, **t)


# -- the CSR slice (K7-K10) ------------------------------------------------------

def random_csr(n, density, seed, device):
    """A seeded random ``n x n`` CSR on the card: each entry present with
    probability *density*, weights uniform in [0, 1)."""
    import brainevent_torch as bt
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, cols = torch.nonzero(
        torch.rand(n, n, generator=gen, device=device) < density,
        as_tuple=True)
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    data = torch.rand(rows.shape[0], generator=gen, device=device)
    return bt.CSR((data, cols.to(torch.int32), indptr), shape=(n, n))


def mm_plan(A, device):
    """The gather plan of the csrmm cell's matrix *A*, built in numpy."""
    from brainevent_torch.ops import mxu_gather as mg
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr.cpu().numpy()))
    return mg.build_mm_plan(rows, A.indices.cpu().numpy(), A.shape).to(device)


def time_k10(W, A, plan, w_sorted, device):
    """K10 at its four shapes, each beside ``torch.sparse.mm`` of the same
    matrix by the same operand (the transposed CSR built outside the timed
    call): the csrmm cell *A* NT over the CSR arrays and over its mm
    *plan*'s row index, and the CSR slice's ``W @ X`` (NT) and ``X @ W``
    (T, over the CSC mirror with its permutation) at B = SLICE_B. Device
    ms a launch, the library call's, the bytes and operations, and each
    twin (timed by the caller)."""
    from brainevent_torch import _misc
    from brainevent_torch.ops import mxu_gather as mg
    gen = torch.Generator(device=device).manual_seed(171)
    X = torch.randn(MM_N, MM_B, generator=gen, device=device)

    def sparse(ptr, idx, vals, shape):
        return torch.sparse_csr_tensor(ptr.long(), idx.long(), vals, shape)

    def row(ptr, idx, perm, w, X, lib, nse):
        n_rows, (n_x, B) = ptr.shape[0] - 1, X.shape
        args = (ptr, idx, perm, w, X, False)
        return dict(ms=device_ms(lambda: mg.csr_gather_mm(*args), 20),
                    library_ms=device_ms(lambda: torch.sparse.mm(lib, X), 20),
                    twin=lambda: mg.csr_gather_mm_twin(*args),
                    bytes=4 * (n_rows + 1) + (12 if perm is not None else 8)
                    * nse + 4 * n_x * B + 4 * n_rows * B,
                    ops=2 * nse * B)

    A_csr = sparse(A.indptr, A.indices, A.data, A.shape)
    res = {'csrmm': row(A.indptr, A.indices, None, A.data, X, A_csr, A.nse)}
    res['plan'] = row(plan.row_ptr, plan.row_cols, plan.row_slots,
                      w_sorted.reshape(-1).contiguous(), X, A_csr, A.nse)
    res['plan']['twin'] = lambda: mg.gather_matmat_xla(plan, w_sorted, X)
    gen = torch.Generator(device=device).manual_seed(151)
    Xs = torch.randn(W.shape[0], SLICE_B, generator=gen, device=device)
    Zt = torch.randn(SLICE_B, W.shape[0], generator=gen,
                     device=device).T.contiguous()
    res['slice NT'] = row(W.indptr, W.indices, None, W.data, Xs,
                          sparse(W.indptr, W.indices, W.data, W.shape), W.nse)
    ptr, idx, perm = _misc.csr_to_csc_index(W.indptr, W.indices,
                                            shape=W.shape)
    res['slice T'] = row(ptr, idx, perm, W.data, Zt,
                         sparse(ptr, idx, W.data[perm.long()], W.shape),
                         W.nse)
    return res


def time_csr_kernels(device):
    """K7 and K8 (homogeneous, bool spikes at 0.1% and 1%) and K9 (STDP's
    gate and trace) on a 10k x 10k CSR at 10%, 10M entries, and K10
    (:func:`time_k10`; its line the mean of the slice's two directions,
    each shape apart under ``by_shape``): device ms a launch, the twin's
    ms a call, the library calls (K9 beside
    ``torch.sparse.sampled_addmm``, checked equal)."""
    from benchmark_torch.harness.roofline import least_seconds
    from brainevent_torch.csr import pallas_kernels as pk
    from brainevent_torch.csr._common import event_gate, row_ids_from_indptr
    from brainevent_torch.ops import pair_gather as pg
    W = random_csr(CSR_N, CSR_DENSITY, 130, device)
    A = random_csr(MM_N, MM_DENSITY, 150, device)
    plan = mm_plan(A, device)
    gen = torch.Generator(device=device).manual_seed(17)
    n = CSR_N
    homo = torch.tensor([0.5], device=device)
    out, details = {}, {}
    for rate in (0.001, 0.01):
        s = torch.rand(n, generator=gen, device=device) < rate
        for op, extra in ((pk.csr_gather_mv, ()), (pk.csr_scatter_mv, (n,))):
            args = (W.indptr, W.indices, None, homo, s, True, *extra)
            r = dict(ms=device_ms(lambda: op(*args), 100),
                     plain_ms=host_ms(lambda: op.twin(*args), 10))
            details[f'{op.name} {rate:.1%}'] = r
            if rate == 0.01:
                out[op.name] = dict(r)
    rows = row_ids_from_indptr(W.indptr, W.nse)
    gate = event_gate(torch.rand(n, generator=gen, device=device) < 0.01)
    trace = torch.rand(n, generator=gen, device=device)
    args = (rows, W.indices, gate, trace)
    out['pair_gather'] = dict(ms=device_ms(lambda: pg.pair_gather(*args), 100),
                              plain_ms=host_ms(
                                  lambda: pg.pair_gather_twin(*args), 10))
    k10 = time_k10(W, A, plan, plan.sort_data(A.data), device)
    for r in k10.values():
        r['plain_ms'] = host_ms(r.pop('twin'), 3)
    # the slice launches K10 at B = 16 once each way a step
    names = ('ms', 'plain_ms', 'library_ms', 'bytes', 'ops')
    out['csr_gather_mm'] = {f: (k10['slice NT'][f] + k10['slice T'][f]) / 2
                            for f in names}
    out['csr_gather_mm']['by_shape'] = {
        name: dict({f: r[f] for f in names[:3]},
                   bound_ms=least_seconds(r['ops'], r['bytes'])[0] * 1e3)
        for name, r in k10.items()}
    # the library calls on the same inputs (s: the 1% spikes), and the
    # bytes moved
    s = s.float()
    Wh = torch.sparse_csr_tensor(W.indptr.long(), W.indices.long(),
                                 homo.expand(W.nse).contiguous(), (n, n))
    act = s[rows] != 0
    tgt, vals = W.indices[act].long(), homo.expand(int(act.sum()))
    y = torch.zeros(n, device=device)
    # K8's function, y = W^T g(s), as one call: the transposed matrix by
    # the float spikes
    Wt = torch.sparse_coo_tensor(
        torch.stack([W.indices.long(), rows.long()]), homo.expand(W.nse),
        (n, n)).coalesce().to_sparse_csr()
    out['csr_gather_mv'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(Wh, s[:, None]), 100),
        bytes=4 * (n + 1) + 4 * W.nse + 5 * n, ops=W.nse)
    out['csr_scatter_mv'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(Wt, s[:, None]), 100),
        bytes=5 * n + 4 * tgt.numel(), ops=tgt.numel())
    details['csr_scatter_mv_selected_index_add_ms'] = device_ms(
        lambda: y.index_add_(0, tgt, vals), 100)
    # K9's function as one call: the SDDMM of the rank-1 product gate
    # trace^T sampled on W's pattern
    W_pat = torch.sparse_csr_tensor(W.indptr.long(), W.indices.long(),
                                    W.data, (n, n))
    sd = lambda: torch.sparse.sampled_addmm(  # noqa: E731
        W_pat, gate[:, None], trace[None, :], beta=0.0)
    check(torch.equal(sd().values(), pg.pair_gather(*args)),
          'K9 equals torch.sparse.sampled_addmm')
    out['pair_gather'].update(bytes=12 * W.nse + 8 * n, ops=W.nse,
                              library_ms=device_ms(sd, 100))
    return out, details


# -- the JITC slice (K11-K14) ----------------------------------------------------

def jitc_run(net, state, n_steps, start=0):
    """*n_steps* JITCNet steps from *state*, *start* steps in."""
    for t in net.times(n_steps, start):
        state = net.step(state, t)
    return state


def jitc_nets(device):
    """``JITCNet`` at :data:`JITC_SCALES`, normal law, COBA, after
    JITC_STEPS steps; then 100 warm-up steps (their state left unused) and
    1,000 steps on the host clock, the clock 100 steps on:
    ``{label: dict(net, us_timed, last_state)}``."""
    import brainevent_torch as bt
    out = {}
    for label, scale in JITC_SCALES.items():
        net = bt.JITCNet(scale=scale, weight_law='normal', coba=True,
                         device=device)
        state = jitc_run(net, net.init_state(), JITC_STEPS)
        jitc_run(net, state, 100, JITC_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = jitc_run(net, state, 1000, JITC_STEPS + 100)
        torch.cuda.synchronize()
        out[label] = dict(net=net, last_state=state,
                          us_timed=(time.perf_counter() - t0) / 1000 * 1e6)
    return out


def k12_kwargs(net):
    """K12's keywords for ``JITCNet``'s E projection: the event scatter
    over ``net.plan_e``, normal law."""
    from brainevent_torch.jitc import pallas_kernels as jk
    from brainevent_torch.jitc.family import _seed
    plan = net.plan_e
    s2, _, cl = plan.setup
    a, b = jk.law_params(1, plan.matrix.data)
    return dict(law=1, a=a, b=b, seed=_seed(plan.matrix.seed), cl=cl,
                n_rows=s2.shape[0], n_cols=net.num, logical_cols=net.num,
                corder=False, event=True)


def recorded_jitc_spikes(net, state):
    """The time and the E spikes of the step after the timed steps."""
    t = net.times(1, JITC_STEPS + 1100)[0]
    spike = net.step(state, t).spike_count != state.spike_count
    return t, spike, spike[:net.n_exc].contiguous()


def time_plan_routes(net, spk, device):
    """K12 over the 80k E plan against K12 drawing each stream's setup
    itself, in the three directions of the class surface's 1-D products:
    the event scatter at the net's recorded spikes *spk* and at 10% and
    100% of the rows spiking, the gather (bitwise on both routes) and the
    float scatter. Device ms a launch."""
    from brainevent_torch.jitc import pallas_kernels as jk
    s2, q2, _ = net.plan_e.setup
    n_rows = s2.shape[0]
    mv_kw = k12_kwargs(net)
    gen = torch.Generator(device=device).manual_seed(21)
    event = dict(corder=False, event=True)
    cases = {
        f'event scatter (spk @ M), {int(spk.sum())} spikes': (spk, event),
        'event scatter, 10% spiking': (torch.rand(
            n_rows, generator=gen, device=device) < 0.1, event),
        'event scatter, 100% spiking': (torch.ones(
            n_rows, dtype=torch.bool, device=device), event),
        'gather (M @ v)': (torch.randn(net.num, generator=gen, device=device),
                           dict(corder=True, event=False)),
        'scatter (u @ M)': (torch.randn(n_rows, generator=gen, device=device),
                            dict(corder=False, event=False))}
    res = {}
    for what, (x, kw) in cases.items():
        kw = dict(mv_kw, **kw)
        res[what] = {route: device_ms(
            lambda: jk.jitc_walk_mv(*plan, x, **kw), 50)
            for route, plan in (('plan', (s2, q2)),
                                ('own setup', (None, None)))}
        if kw['corder']:
            check(torch.equal(jk.jitc_walk_mv(s2, q2, x, **kw),
                              jk.jitc_walk_mv(None, None, x, **kw)),
                  'K12 gather, plan vs own setup')
    return res


def time_jitc_host(net, state, spike, t, n_rep=1000, n_prof=200):
    """Where a JITCNet step's host time goes at 80k: us a step and a
    propagation (the two K12 wrappers), and cProfile's functions by own
    time over *n_prof* steps."""
    import cProfile
    import pstats
    res = dict(step_us=host_ms(lambda: net.step(state, t), n_rep) * 1e3,
               propagate_us=host_ms(lambda: net._propagate(spike), n_rep)
               * 1e3)
    prof = cProfile.Profile()
    prof.enable()
    jitc_run(net, state, n_prof, JITC_STEPS + 1100)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])
    res['cprofile_us'] = sum(v[2] for v in stats.values()) / n_prof * 1e6
    res['cprofile_top'] = [
        (f'{f.rsplit("/", 1)[-1]}:{line}:{name}'[-60:], v[1] // n_prof,
         v[2] / n_prof * 1e6) for (f, line, name), v in rows[:15]]
    return res


def time_jitc(device, n=JITC_N):
    """K11 and K12 at the 80k ``JITCNet``'s E plan and the spikes of one
    of its steps; K13 (both strides, B = 256) and K14 (both strides) at
    (n, n, 1%), the normal law: device ms a launch and the twin's ms a
    call. Beside them the nets' us/step, the ``jitn`` todense call (the
    fill and K14), K12 over a plan and drawing its own setup
    (:func:`time_plan_routes`), the host path and 10 profiled steps at
    80k."""
    import brainevent_torch as bt
    from brainevent_torch._misc import _initialize_conn_length
    from brainevent_torch.jitc import pallas_kernels as jk
    nets = jitc_nets(device)
    net, state = nets['80k']['net'], nets['80k']['last_state']
    s2, q2, cl = net.plan_e.setup
    n_rows, L = s2.shape
    t, spike, spk = recorded_jitc_spikes(net, state)
    mv_kw = k12_kwargs(net)
    n_act = int(spk.sum())
    k12_visits = int(jk.jitc_walk_mv.twin(
        s2, q2, spk, **dict(mv_kw, law=0, a=1.0)).sum())
    setup_kw = dict(seed=mv_kw['seed'], cl=cl, n_rows=n_rows, n_cols=net.num,
                    chunk_size=-(-net.num // 4), stride=32)
    se, qe = torch.empty_like(s2), torch.empty_like(q2)
    res = {}
    res['jitc_walk_setup'] = dict(
        ms=device_ms(lambda: jk.jitc_walk_setup(se, qe, **setup_kw), 10),
        plain_ms=host_ms(lambda: jk.jitc_walk_setup.twin(se, qe, **setup_kw),
                         1),
        bytes=8 * s2.numel(), ops=SETUP_OPS * s2.numel())
    res['jitc_walk_mv'] = dict(
        ms=device_ms(lambda: jk.jitc_walk_mv(s2, q2, spk, **mv_kw), 200),
        plain_ms=host_ms(lambda: jk.jitc_walk_mv.twin(s2, q2, spk, **mv_kw),
                         10),
        bytes=n_rows + 8 * n_act * L + 4 * net.num,
        ops=VISIT_OPS[1] * k12_visits)
    code, a, b = JITC_NORMAL
    clen = _initialize_conn_length(JITC_PROB)
    dense = torch.zeros(n, n, device=device)
    jk.jitc_walk_todense(dense, None, None, law=code, a=a, b=b,
                         seed=JITC_SEED, cl=clen, corder=True)
    nv = int((dense != 0).sum())
    plan = jk.walk_plan_setup(JITC_SEED, clen, n, n, -(-n // 4),
                              device=device)[:2]
    gen = torch.Generator(device=device).manual_seed(20)
    B = torch.randn(n, 256, generator=gen, device=device)
    kw = dict(law=code, a=a, b=b, seed=JITC_SEED, cl=clen, n_rows=n,
              n_cols=n, logical_cols=n, corder=True, event=False)
    for op, p in ((jk.jitc_walk_mm, plan), (jk.jitc_walk_mm4, (None, None))):
        res[op.name] = dict(
            ms=device_ms(lambda: op(*p, B, **kw), 10),
            plain_ms=host_ms(lambda: op.twin(*p, B, **kw), 2),
            bytes=8 * n * 256 + (8 * p[0].numel() if p[0] is not None
                                 else 0),
            ops=nv * (VISIT_OPS[code] + 2 * 256) + (
                0 if p[0] is not None else SETUP_OPS * n * 16))
    dkw = dict(law=code, a=a, b=b, seed=JITC_SEED, cl=clen, corder=True)
    for op in (jk.jitc_walk_todense, jk.jitc_walk_todense4):
        res[op.name] = dict(
            ms=device_ms(lambda: op(dense, None, None, **dkw), 10),
            plain_ms=host_ms(lambda: op.twin(dense.zero_(), None, None,
                                             **dkw), 2),
            # the kernel stores the nv weights; the zeros of the output
            # are the wrapper's fill, outside the timed call
            bytes=4 * nv, ops=nv * VISIT_OPS[code] + SETUP_OPS * n * (
                128 if op is jk.jitc_walk_todense else 16))
    details = dict(
        jitcnet_us_per_step={k: o['us_timed'] for k, o in nets.items()},
        k12=time_plan_routes(net, spk, device),
        host_80k=time_jitc_host(net, state, spike, t),
        profiled_80k=profiled(lambda: jitc_run(net, state, 10,
                                               JITC_STEPS + 1100), device, 10),
        # the todense call as a user makes it: the wrapper's fill of the
        # output and K14, beside the least time of writing the output
        jitn_todense_ms={mode: device_ms(lambda: bt.jitn(
            a, b, JITC_PROB, JITC_SEED, shape=(n, n), matrix_mode=mode,
            device=device), 10) for mode in ('mv', 'mm')},
        jitn_todense_output_bytes=4 * n * n)
    return res, details


# -- the dense slice and the event encoders (K15-K18) ----------------------------

def dense_step_loop(W, n_steps, device):
    """The dense slice from the ``Dense`` *W*: a step is ``s @ W`` and ``W @
    s`` at 1%, the traces' decay, STDP on-pre and on-post with clip [-1,
    1], ``W @ S`` (S (n, 128) at 1%) and the encoders of S."""
    import brainevent_torch as bt
    gen = torch.Generator(device=device).manual_seed(23)
    n = W.shape[0]
    pre_tr = post_tr = torch.zeros(n, device=device)
    for _ in range(n_steps):
        pre = torch.rand(n, generator=gen, device=device) < DENSE_RATE
        post = torch.rand(n, generator=gen, device=device) < DENSE_RATE
        S = torch.rand(n, DENSE_B, generator=gen, device=device) < DENSE_RATE
        bt.BinaryArray(pre) @ W
        W @ bt.BinaryArray(post)
        pre_tr, post_tr = pre_tr * 0.95 + pre, post_tr * 0.95 + post
        W = W.update_on_pre(pre, post_tr, -1.0, 1.0)
        W = W.update_on_post(pre_tr, post, -1.0, 1.0)
        W @ bt.BinaryArray(S)
        bt.CompactBinary.from_array(S)
        bt.binary_2d_csr_encode_p_call(S)
    return W


def dense_slice_times(W, device, n_steps):
    """*n_steps* steps of the dense slice from *W* on the host clock (ms a
    step), then 10 profiled steps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_step_loop(W, n_steps, device)
    torch.cuda.synchronize()
    return dict(ms=(time.perf_counter() - t0) / n_steps * 1e3,
                **profiled(lambda: dense_step_loop(W, 10, device), device,
                           10))


def time_k15(W, s):
    """K15 both ways on the (n, n) weights *W* and the bool spikes *s*:
    device ms a launch, the twin's ms, the bytes and operations, and
    ``torch.matmul`` of the float gate (TF32 off)."""
    from brainevent_torch.dense import pallas_kernels as dk
    torch.backends.cuda.matmul.allow_tf32 = False
    n, n_act, g = W.shape[0], int(s.sum()), s.float()
    out = {}
    for name, transpose, lib, n_bytes in (
            ('dense_event_mv T', True, lambda: torch.matmul(g, W),
             4 * n * n_act),
            ('dense_event_mv NT', False, lambda: torch.matmul(W, g),
             32 * n * n_act)):
        out[name] = dict(
            ms=device_ms(lambda: dk.dense_event_mv(W, s, transpose), 200),
            plain_ms=host_ms(lambda: dk.dense_event_mv.twin(W, s, transpose),
                             20),
            library_ms=device_ms(lib, 200), bytes=n_bytes + n + 4 * n,
            ops=n * n_act)
    return out


def time_dense_kernels(device):
    """K15-K18 at the dense slice's shapes, (10k, 10k) weights at 1% (K16
    also at 10% and 50%, both ways; K18 on (10k, 128)): device ms a
    launch, the twin's ms, the bytes and operations, and one PyTorch call
    computing the same function (``torch.matmul`` with TF32 off,
    ``torch.addr``, ``torch.count_nonzero``)."""
    from brainevent_torch.dense import pallas_kernels as dk
    from brainevent_torch.events import pallas_kernels as ek
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(24)
    n, b = DENSE_N, DENSE_B
    W = torch.randn(n, n, generator=gen, device=device)
    s = torch.rand(n, generator=gen, device=device) < DENSE_RATE
    x = torch.rand(n, b, generator=gen, device=device) < DENSE_RATE
    trace = torch.rand(n, generator=gen, device=device)
    g = s.float()
    out = time_k15(W, s)

    def timed(name, op, args, reps, reps_twin, library, n_bytes, n_ops):
        out[name] = dict(ms=device_ms(lambda: op(*args), reps),
                         plain_ms=host_ms(lambda: op.twin(*args), reps_twin),
                         library_ms=device_ms(library, reps), bytes=n_bytes,
                         ops=n_ops)

    # K16 at the slice's 1% (W @ S, the main path) and at 10% and 50%: the
    # event form's adds grow as m n k rate. The bytes are W once (the rows
    # some column needs, transposed), S and Y.
    for rate in (DENSE_RATE, 0.1, 0.5):
        S = torch.rand(n, b, generator=gen, device=device) < rate
        G, rows_needed = S.float(), int(S.any(dim=1).sum())
        for transpose in (False, True):
            timed(f'dense_event_mm {"T" if transpose else "NT"} {rate:.0%}',
                  dk.dense_event_mm, (W, S, transpose), 10, 5,
                  (lambda G_=G: torch.matmul(W.T, G_)) if transpose
                  else (lambda G_=G: torch.matmul(W, G_)),
                  4 * n * (rows_needed if transpose else n) + n * b
                  + 4 * n * b, 2 * int(S.sum()) * n)
    for name, op, args, lib in (
            ('dense_stdp_pre', dk.dense_stdp_pre, (W, s, trace, -1.0, 1.0),
             lambda: torch.addr(W, g, trace)),
            ('dense_stdp_post', dk.dense_stdp_post, (W, trace, s, -1.0, 1.0),
             lambda: torch.addr(W, trace, g))):
        timed(name, op, args, 50, 10, lib, 8 * n * n + 5 * n, 3 * n * n)
    timed('event_row_count', ek.event_row_count, (x,), 200, 20,
          lambda: torch.count_nonzero(x, dim=1), x.numel() + 4 * x.shape[0],
          x.numel())
    out['dense_event_mv'] = out['dense_event_mv T']
    out['dense_event_mm'] = out[f'dense_event_mm NT {DENSE_RATE:.0%}']
    return out


# -- the EI strategies: the dense count table, K21's table instance and K19 -----

def dense_k19(net, state, n_steps, inp=20.0):
    """The dense strategy's route above the table instance's capacity, the
    loop of K1 and K19 (2n + 1 launches): ``EINet._simulate`` with K1 as
    its step op and the table. Returns the five outputs."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.models import sim
    return fields(net._simulate(state, net.times(n_steps), inp,
                                step_op=nw.einet_step,
                                table=sim.dense_count_table(net)))


def recorded_spikes(net, state, steps_done, device):
    """The spike list of one K1 step from *state* (a run's five outputs,
    *steps_done* steps in): ``(ids, n_ids)`` as K19 and K20 read them."""
    from brainevent_torch.models import networks as nw
    num = net.num
    b = [x.clone() for x in state[:4]]
    b += [torch.zeros(2, num, dtype=torch.int32, device=device),
          state[4].clone(), torch.zeros(num, dtype=torch.int32, device=device),
          torch.zeros(2, dtype=torch.int32, device=device)]
    t = float(F32(steps_done) * F32(net.dt))
    nw.einet_step(*b, net.step_params(), t, steps_done & 1, True, True)
    parity = steps_done & 1
    return b[6], b[7][parity:parity + 1]


def time_dense_routes(net, n_steps, warm):
    """COBA us/step (host clock, each call's table build included) of the
    dense strategy through K21's table instance and through K1 + K19, in
    turns K21, K1 + K19, K1 + K19, K21, from the state *warm* dense steps
    in, each bitwise the other route. Returns ``({route: [us, us]}, K21's
    final state)``."""
    import brainevent_torch as bt
    state = bt.einet_pallas_sim(net, net.init_state(), warm,
                                strategy='dense')
    state = bt.EINetState(bt.LIFRefState(state[0], state[1]), *state[2:])
    runs, outs = {'K21': [], 'K1 + K19': []}, {}
    for route in ('K21', 'K1 + K19', 'K1 + K19', 'K21'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == 'K21':
            out = bt.einet_pallas_sim(net, state, n_steps, strategy='dense')
        else:
            out = dense_k19(net, state, n_steps)
        torch.cuda.synchronize()
        runs[route].append((time.perf_counter() - t0) / n_steps * 1e6)
        outs[route] = out
    check(same_bits(outs['K21'], outs['K1 + K19']), ('dense routes', net.num))
    final = outs['K21']
    return runs, bt.EINetState(bt.LIFRefState(*final[:2]), *final[2:])


def table_sim_line(net, state, start, table, device):
    """The table instance's line at COBA 4k: one launch of EI_STEPS steps
    from *state*, *start* steps in (device ms), its twin's ms on the same
    inputs (bitwise equal), and the work this run needs: the state read
    and written once, the step times, the table rows of the neurons that
    spiked, 20 operations a neuron a step and one add a hit."""
    from brainevent_torch.models import networks as nw
    ms, got = sim_device_ms(net, state, EI_STEPS, start, table=table)
    want = [x.clone() for x in fields(state)]
    times = torch.tensor(net.times(start + EI_STEPS)[start:],
                         dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nw.einet_sim_twin(*want, net.conn_all, times, net.step_params(),
                      net.n_exc, table)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(got, want), 'table instance line vs twin')
    new = got[4] - state.spike_count
    return dict(ms=ms, plain_ms=plain_ms,
                bytes=40 * net.num + 4 * EI_STEPS + net.num
                * table.element_size() * int((new > 0).sum()),
                ops=20 * net.num * EI_STEPS
                + net.conn_all.shape[1] * int(new.sum()))


def time_dense(device):
    """COBA at :data:`DENSE_TIMES`: us/step of the dense strategy through
    K21's table instance and through K1 + K19 in turns, mxu3 beside; the
    table instance's device us/step by NPT and walk, and K21 over conn,
    over EI_STEPS steps on from there; K19's device ms a launch on a
    recorded spike list, its twin's, and ``torch.matmul`` of the (2, num)
    float32 masks with the float32 table (TF32 off); the table instance's
    line at 4k; the walks at :data:`WALK_SCALES` (:func:`time_walks`)."""
    import brainevent_torch as bt
    from brainevent_torch.models import networks as nw
    from brainevent_torch.models import sim
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for label, scale, n_steps, warm in DENSE_TIMES:
        net = bt.EINet(scale=scale, device=device)
        runs, final = time_dense_routes(net, n_steps, warm)
        us = {'dense': runs['K21'], 'K1 + K19': runs['K1 + K19']}
        us['mxu3'], rate, _ = time_run(net, n_steps, warm, 'mxu3')
        num = net.num
        table = sim.dense_count_table(net)
        by_npt = {}
        for k in nw.SIM_SOURCE_NPT[table.dtype]:
            if -(-num // (k * nw.SIM_BLOCK)) > nw.einet_sim_max_blocks(
                    device, k, table.dtype):
                continue
            for walk in ('block', 'grid'):
                ms, _ = sim_device_ms(net, final, EI_STEPS, n_steps,
                                      table=table, npt=k,
                                      grid_walk=walk == 'grid')
                by_npt[f'{k} {walk}'] = ms / EI_STEPS * 1e3
        conn_ms, _ = sim_device_ms(net, final, EI_STEPS, n_steps)
        ids, n_ids = recorded_spikes(net, fields(final), n_steps, device)
        n_act = int(n_ids)
        counts = torch.zeros(2, num, dtype=torch.int32, device=device)
        reps, reps_twin = (500, 100) if num < 40_000 else (200, 20)
        args = (ids, n_ids, table, net.n_exc, counts)
        sel = ids[:n_act].long()
        masks = torch.zeros(2, num, device=device)
        masks[0, sel[sel < net.n_exc]] = 1.0
        masks[1, sel[sel >= net.n_exc]] = 1.0
        table_f32 = table.float()
        res[label] = dict(
            ms=device_ms(lambda: sim.einet_dense_hits(*args), reps),
            plain_ms=host_ms(lambda: sim.einet_dense_hits_twin(*args),
                             reps_twin),
            library_ms=device_ms(lambda: torch.matmul(masks, table_f32), 50),
            bytes=n_act * (num * table.element_size() + 4) + 8 * num,
            n_act=n_act, rate=rate, us_per_step=us,
            table_device_us_by_npt=by_npt,
            grid=nw.einet_sim_grid(num, device, table.dtype),
            walk='grid' if nw.table_grid_walk(table) else 'block',
            conn_device_us=conn_ms / EI_STEPS * 1e3)
        del table_f32
        if label == '4k':
            res['table'] = table_sim_line(net, final, n_steps, table, device)
        del table
    res['walks'] = time_walks(device)
    return res


def time_walks(device):
    """The table instance's device us/step at NPT 1 by walk, each block its
    own rows or the whole grid, in turns block, grid, grid, block, over
    EI_STEPS COBA steps on from DENSE_TIME_WARM mxu3 steps, at each of
    :data:`WALK_SCALES`, the walks bitwise each other. Returns ``{num:
    dict}`` with the spikes a step and the package's choice."""
    import brainevent_torch as bt
    from brainevent_torch.models import networks as nw
    from brainevent_torch.models import sim
    res = {}
    for scale in WALK_SCALES:
        net = bt.EINet(scale=scale, device=device)
        out = bt.einet_pallas_sim(net, net.init_state(), DENSE_TIME_WARM,
                                  strategy='mxu3')
        final = bt.EINetState(bt.LIFRefState(*out[:2]), *out[2:])
        table = sim.dense_count_table(net)
        us, got = {'block': [], 'grid': []}, {}
        for walk in ('block', 'grid', 'grid', 'block'):
            ms, got[walk] = sim_device_ms(net, final, EI_STEPS,
                                          DENSE_TIME_WARM, table=table,
                                          npt=1, grid_walk=walk == 'grid')
            us[walk].append(ms / EI_STEPS * 1e3)
        check(same_bits(got['block'], got['grid']), ('walks', net.num))
        res[net.num] = dict(
            us=us, blocks=nw.einet_sim_grid(net.num, device, table.dtype)[1],
            spikes_per_step=int((got['grid'][4] - final.spike_count).sum())
            / EI_STEPS,
            choice='grid' if nw.table_grid_walk(table) else 'block')
        del table, net, final, out
    return res


# -- the multi-device layer's kernels: K20 and K22 --------------------------------

def time_k20(device):
    """K20 at world size 1 (one shard of ``num``) on the spike list of a
    step DENSE_TIME_WARM steps into a COBA run at :data:`SHARD_NETS`:
    device ms a launch, its twin's, ``index_add_``'s."""
    import brainevent_torch as bt
    from brainevent_torch.parallel import mega
    res = {}
    for label, scale in SHARD_NETS:
        net = bt.EINet(scale=scale, device=device)
        final = bt.einet_pallas_sim(net, net.init_state(), DENSE_TIME_WARM)
        ids, n_ids = recorded_spikes(net, final, DENSE_TIME_WARM, device)
        n_act, num = int(n_ids), net.num
        counts = torch.zeros(1, 2, num, dtype=torch.int32, device=device)
        args = (ids, n_ids, net.conn_all, 0, net.n_exc, counts)
        reps, reps_twin = (500, 100) if num < 40_000 else (200, 20)
        res[label] = dict(
            ms=device_ms(lambda: mega.mega_counts(*args), reps),
            plain_ms=host_ms(lambda: mega.mega_counts_twin(*args), reps_twin),
            library_ms=index_add_ms(net, ids, n_act, reps, device),
            bytes=count_scatter_bytes(n_act, net.conn_all.shape[1]),
            n_act=n_act)
    return res


def time_shard_step(device):
    """K22's device ms a launch at world size 1 (``n_loc = num``) from a
    COBA run's state after DENSE_TIME_WARM steps at :data:`SHARD_NETS`,
    queued back to back (fold and step, the parity alternating), beside
    the route it replaced, K1 + memset + K20, for the same steps, and
    K22's twin's ms; the bytes one step must move: v, t_last, g_e, g_i and
    two counts read and v, g_e, g_i written a neuron, t_last and
    spike_count of each spike, its row of conn, and the other parity's
    ``2 * num`` partials zeroed (the hits add into partials that the
    zeroing left in L2, so they move no bytes of their own)."""
    import brainevent_torch as bt
    from brainevent_torch.models import networks as nw
    from brainevent_torch.parallel import mega
    res = {}
    for label, scale in SHARD_NETS:
        net = bt.EINet(scale=scale, device=device)
        final = bt.einet_pallas_sim(net, net.init_state(), DENSE_TIME_WARM)
        num, n_conn = net.num, net.conn_all.shape[1]
        p = net.step_params()
        b = [x.clone() for x in final[:4]]
        counts = torch.zeros(2, num, dtype=torch.int32, device=device)
        spike_count = final[4].clone()
        partials = torch.zeros(2, 1, 2, num, dtype=torch.int32, device=device)
        clock = [DENSE_TIME_WARM]

        def k22(op):
            t = float(F32(clock[0]) * F32(net.dt))
            op(*b, counts, spike_count, partials, net.conn_all, 0, net.n_exc,
               p, t, clock[0] & 1, True, True)
            clock[0] += 1

        before = int(spike_count.sum())
        k22(mega.einet_shard_step)
        torch.cuda.synchronize()
        n_act = int(spike_count.sum()) - before
        reps, reps_twin = (500, 100) if num < 40_000 else (200, 20)
        ms = device_ms(lambda: k22(mega.einet_shard_step), reps)
        twin_ms = host_ms(lambda: k22(mega.einet_shard_step_twin), reps_twin)
        k1b = [x.clone() for x in final[:4]] + [
            counts.clone(), spike_count.clone(),
            torch.zeros(num, dtype=torch.int32, device=device),
            torch.zeros(2, dtype=torch.int32, device=device)]
        full = torch.zeros(1, 2, num, dtype=torch.int32, device=device)

        def parent():
            k = clock[0]
            nw.einet_step(*k1b, p, float(F32(k) * F32(net.dt)), k & 1, True,
                          True)
            full.zero_()
            mega.mega_counts(k1b[6], k1b[7][k & 1:(k & 1) + 1], net.conn_all,
                             0, net.n_exc, full)
            clock[0] += 1

        # three launches a call: a quarter of the calls keeps the queue
        # behind the sleep kernel within the device's pending-launch limit
        res[label] = dict(ms=ms, plain_ms=twin_ms,
                          parent_ms=device_ms(parent, reps // 4),
                          n_act=n_act, bytes=36 * num + 8 * n_act
                          + 4 * n_act * n_conn + 8 * num)
    return res


# -- the microcircuit (K23) --------------------------------------------------------

def time_k23(device):
    """K23 on the Potjans-Diesmann microcircuit at MC_SCALE: one launch
    of MC_STEPS steps after MC_WARM (device ms, CUDA events), the twin
    (``mc_loop``) on the card from the same state (bitwise equal), and
    the work ``benchmark_torch/work/pd_microcircuit.py`` counts for that
    launch."""
    import brainevent_torch as bt
    from brainevent_torch.models import microcircuit as mc
    from benchmark_torch.work import pd_microcircuit as work
    net = bt.MicrocircuitNet(scale=MC_SCALE, device=device)
    warm = net.run(MC_WARM, state=net.init_state())
    names = ('v', 'i_syn', 'ref', 'ring', 'spike_count')
    p = net.step_params(warm.key, warm.step)
    rows = (net.row_ptr, net.targets, net.weights, net.delays)
    got = [getattr(warm, k).clone() for k in names]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    mc.mc_sim(*got, *rows, MC_STEPS, p, plan=net.plan)
    b.record()
    torch.cuda.synchronize()
    want = [getattr(warm, k).clone() for k in names]
    t0 = time.perf_counter()
    mc.mc_loop(*want, *rows, MC_STEPS, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(got, want), 'K23 vs twin')
    new = got[4] - warm.spike_count
    inputs = dict(num=net.num, depth=net.depth,
                  net=dict(degree=(net.row_ptr[1:] - net.row_ptr[:-1])))
    total = work.reduce(None, inputs, dict(spike_count=new))
    n_ops, n_bytes = work.count(None, inputs, total, 1, MC_STEPS)
    seconds = MC_STEPS * net.params.dt * 1e-3
    return dict(ms=a.elapsed_time(b), plain_ms=plain_ms, bytes=n_bytes,
                ops=n_ops, blocks=mc.mc_sim_grid(net.num, device),
                rates_hz=[float(new[i:j].double().mean()) / seconds
                          for i, j in zip(net.pop_start[:-1],
                                          net.pop_start[1:])])


# -- the HPC benchmark network with STDP (K24) -------------------------------------

def time_k24(device):
    """K24 on NEST's HPC benchmark network at HPC_SCALE: one launch of
    HPC_STEPS steps after HPC_WARM (device ms, CUDA events), the twin
    (``stdp_loop``) on the card from the same state (bitwise equal), and
    the work ``benchmark_torch/work/hpc_stdp.py`` counts for that launch
    (the state read and written once; not the weights' copy, which
    ``run`` makes)."""
    import brainevent_torch as bt
    from brainevent_torch.models import hpc_stdp as hs
    from benchmark_torch.work import hpc_stdp as work
    net = bt.HpcStdpNet(scale=HPC_SCALE, device=device)
    warm = net.run(HPC_WARM, state=net.init_state())
    p = net.step_params(warm.key, warm.step)
    rows = (net.targets, net.plastic_ptr, net.static_ptr)
    got = [getattr(warm, k).clone() for k in hs.STATE_FIELDS]
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    hs.stdp_sim(*got, *rows, HPC_STEPS, p, scratch=net.plan)
    b.record()
    torch.cuda.synchronize()
    want = [getattr(warm, k).clone() for k in hs.STATE_FIELDS]
    t0 = time.perf_counter()
    hs.stdp_loop(*want, *rows, HPC_STEPS, p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(got, want), 'K24 vs twin')
    out = dict(zip(hs.STATE_FIELDS, got), step=warm.step + HPC_STEPS)
    out['spike_count'] = out['spike_count'] - warm.spike_count
    # the facilitations of the launch: those of its E spikes, but for the
    # last d steps', and those the warm state's last d steps owed
    owed = warm.spiked.to(torch.int64).sum(0) - warm.spiked[warm.step
                                                            % net.depth]
    inputs = dict(num=net.num, ne=net.n_exc, depth=net.depth,
                  net=dict(targets=net.targets, plastic_ptr=net.plastic_ptr,
                           static_ptr=net.static_ptr, weights=net.weights))
    total = work.reduce(None, inputs, out)
    total[2] += (owed * inputs['degrees'][2]).sum()
    n_ops, n_bytes = work.count(None, inputs, total, 1, HPC_STEPS)
    n_bytes -= 8 * net.n_plastic  # the trial's copy of the weights: run's
    seconds = HPC_STEPS * net.params.dt * 1e-3
    new = out['spike_count'].double()
    return dict(ms=a.elapsed_time(b), plain_ms=plain_ms, bytes=n_bytes,
                ops=n_ops, blocks=hs.stdp_sim_grid(net.num, device),
                rates_hz=[float(new[:net.n_exc].mean()) / seconds,
                          float(new[net.n_exc:].mean()) / seconds])


# -- the two modes ---------------------------------------------------------------

def device_line():
    """The card and the library build, printed before any timing."""
    from benchmark_torch.harness.device import power_limit
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; '
          f'{power_limit()}; {torch.cuda.device_count()} device(s)',
          flush=True)


def time_kernels_line(device):
    """Every timer of this checkout's kernels; prints the two lines."""
    import brainevent_torch as bt
    from benchmark_torch.harness.roofline import least_seconds
    from brainevent_torch.ops.core import REGISTRY
    details = {}
    phase('K21, K1 and K2: the EI network')
    nets = {label: bt.EINet(scale=scale, coba=True, device=device)
            for label, scale, _, _ in EI_TIMES}
    details['ei'], finals = time_ei(nets, device)
    k1k2 = time_kernels(nets, finals, device)
    k21 = time_k21(nets['4k'], bt.EINetState(
        bt.LIFRefState(*finals['4k'][1][:2]), *finals['4k'][1][2:]),
        details['ei']['4k'], device)
    details['k1_k2'] = k1k2
    del nets, finals
    phase('K3-K6: the training slice and binary_fcnmv')
    model = bt.SurrogateSNN(**BIG, seed=2, device=device)
    k3_k6, details['k3_k6'] = time_new_kernels(model, device)
    del model
    phase('K7-K10: the CSR slice')
    k7_k10, details['k7_k10'] = time_csr_kernels(device)
    phase('K11-K14: the JITC walk')
    k11_k14, details['k11_k14'] = time_jitc(device)
    phase('K15-K18: the dense slice and the encoders')
    k15_k18 = time_dense_kernels(device)
    details['k15_k18'] = {k: v for k, v in k15_k18.items()
                          if k.startswith('dense_event_m')}
    phase('K19 and K21\'s table instance: the dense strategy')
    dense = time_dense(device)
    details['dense_strategy'] = dense
    phase('K20 and K22: the sharded step')
    k20, k22 = time_k20(device), time_shard_step(device)
    details['k20'], details['k22'] = k20, k22
    phase('K23: the microcircuit')
    k23 = details['k23'] = time_k23(device)
    phase('K24: the HPC benchmark network with STDP')
    k24 = details['k24'] = time_k24(device)

    def entry(op_name, t, **extra):
        op = REGISTRY[op_name]
        bound_s, bound_by = least_seconds(t.get('ops', 0), t['bytes'])
        return dict({'name': op_name, 'source': op.source,
                     'replaces': op.replaces, 'ms': t['ms'],
                     'plain_ms': t['plain_ms'], 'bound_ms': bound_s * 1e3,
                     'bound_by': bound_by,
                     'library_ms': t.get('library_ms')}, **extra)

    t4k = k1k2['4k']
    kernels = [
        entry('einet_step', dict(ms=t4k['k1_ms'], plain_ms=t4k['k1_twin_ms'],
                                 bytes=t4k['k1_bytes'], ops=20 * 4000)),
        entry('event_count_scatter', dict(
            ms=t4k['k2_ms'], plain_ms=t4k['k2_twin_ms'],
            bytes=t4k['k2_bytes'], library_ms=t4k['k2_library_ms'])),
        entry('einet_sim', k21)]
    for group in (k3_k6, k7_k10, k11_k14):
        kernels += [entry(name, t, **({'by_shape': t['by_shape']}
                                      if 'by_shape' in t else {}))
                    for name, t in group.items()]
    kernels += [entry(name, k15_k18[name]) for name in (
        'dense_event_mv', 'dense_event_mm', 'dense_stdp_pre',
        'dense_stdp_post', 'event_row_count')]
    kernels += [
        entry('einet_dense_hits', dense['4k'],
              yardstick='the dense route above the table capacity, K1 + K19'),
        entry('mega_counts', k20['400k'],
              yardstick='the sharded step K22 replaced, K1 + memset + K20'),
        dict(entry('einet_sim', dense['table']), name='einet_sim_table',
             replaces='brainevent_tpu/models/pallas_sim.py:532'),
        entry('einet_shard_step', k22['400k']),
        entry('mc_sim', k23), entry('stdp_sim', k24)]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'details': details}, default=str))
    return 0


def time_tree(tree, parts=TREE_PARTS):
    """``--tree DIR``: time DIR's ``brainevent_torch`` by this file's code,
    so that two checkouts are timed by the same code: run it for each in
    turns (A, B, B, A). *parts*:

    - ``k10``: :func:`time_k10` (the CSR pattern, the csrmm cell and its
      plan);
    - ``jitc``: the ``JITCNet`` steps, :func:`time_plan_routes` and 10
      profiled steps (the 4k and 80k nets after JITC_STEPS steps, the
      spikes of step JITC_STEPS + 1100);
    - ``k15``: :func:`time_k15` at (10k, 10k, 1%), both ways;
    - ``train``: the timed and profiled train steps of the 100k x 100
      model (:func:`train_step_times`), through the tree's own
      ``train_step``;
    - ``dense``: the dense slice, 20 steps on the host clock and 10
      profiled (:func:`dense_slice_times`);
    - ``ei``: COBA runs through ``einet_pallas_sim`` at :data:`EI_TIMES`
      (:func:`time_run`, twice each), so that a design variant of the EI
      route can be timed beside this tree's;
    - ``ei_dense``: COBA runs of the dense strategy at :data:`DENSE_TIMES`
      (:func:`time_run`, twice each, bitwise mxu3) and its one launch's
      device us/step over EI_STEPS steps on from there.

    Prints one JSON line."""
    tree = str(Path(tree).resolve())
    sys.path.insert(0, tree)
    device = torch.device('cuda:0')
    import brainevent_torch as bt
    from brainevent_torch.ops import cuda_build
    check(str(Path(bt.__file__).resolve().parents[1]) == tree,
          ('brainevent_torch not from', tree, bt.__file__))
    cuda_build.library()
    res = {'tree': tree, 'nvcc_s': cuda_build.last_build_seconds()}
    if 'k10' in parts:
        W = random_csr(CSR_N, CSR_DENSITY, 130, device)
        A = random_csr(MM_N, MM_DENSITY, 150, device)
        plan = mm_plan(A, device)
        k10 = time_k10(W, A, plan, plan.sort_data(A.data), device)
        res['k10'] = {k: {f: r[f] for f in ('ms', 'library_ms')}
                      for k, r in k10.items()}
        del W, A, plan
    if 'jitc' in parts:
        nets = jitc_nets(device)
        net, state = nets['80k']['net'], nets['80k']['last_state']
        res['k12'] = time_plan_routes(
            net, recorded_jitc_spikes(net, state)[2], device)
        res['jitcnet_us_per_step'] = {k: o['us_timed']
                                      for k, o in nets.items()}
        res['jitcnet_80k_kernel_us_per_step'] = profiled(
            lambda: jitc_run(net, state, 10, JITC_STEPS + 1100), device,
            10)['kernel_us']
        del nets, net, state
    if 'k15' in parts:
        gen = torch.Generator(device=device).manual_seed(24)
        W = torch.randn(DENSE_N, DENSE_N, generator=gen, device=device)
        s = torch.rand(DENSE_N, generator=gen, device=device) < DENSE_RATE
        res['k15'] = {k: {f: r[f] for f in ('ms', 'library_ms')}
                      for k, r in time_k15(W, s).items()}
        del W
    if 'train' in parts:
        model = bt.SurrogateSNN(**BIG, seed=2, device=device)
        x = torch.rand(50, BIG['n_in'], generator=torch.Generator(
            device='cpu').manual_seed(10)).to(device)
        p, _ = bt.train_step(model, model.init_params(), x, 3, lr=1e-3)
        res['train'] = train_step_times(model, p, x)
        del model
    if 'dense' in parts:
        gen = torch.Generator(device=device).manual_seed(210)
        W = bt.Dense(torch.randn(DENSE_N, DENSE_N, generator=gen,
                                 device=device))
        dense_step_loop(W, 5, device)
        res['dense'] = dense_slice_times(W, device, 20)
        del W
    if 'ei' in parts:
        res['ei'] = {}
        for label, scale, n_steps, warm in EI_TIMES:
            net = bt.EINet(scale=scale, device=device)
            res['ei'][label] = [time_run(net, n_steps, warm)[0]
                                for _ in range(2)]
    if 'ei_dense' in parts:
        from brainevent_torch.models import sim
        res['ei_dense'] = {}
        for label, scale, n_steps, warm in DENSE_TIMES:
            net = bt.EINet(scale=scale, device=device)
            runs = [time_run(net, n_steps, warm, 'dense') for _ in range(2)]
            out = runs[-1][2]
            check(same_bits(out, time_run(net, n_steps, warm, 'mxu3')[2]),
                  ('dense bitwise mxu3', label))
            final = bt.EINetState(bt.LIFRefState(*out[:2]), *out[2:])
            ms, _ = sim_device_ms(net, final, EI_STEPS, n_steps,
                                  table=sim.dense_count_table(net))
            res['ei_dense'][label] = dict(us=[us for us, _, _ in runs],
                                          device_us=ms / EI_STEPS * 1e3)
    print(json.dumps(res, default=str))
    return 0


def main():
    ap = argparse.ArgumentParser(description='Time brainevent_torch\'s CUDA '
                                 'kernels on one NVIDIA GPU.')
    ap.add_argument('--tree', help='only time this checkout\'s '
                    'brainevent_torch (see time_tree)')
    ap.add_argument('--parts', default=','.join(TREE_PARTS),
                    help='with --tree, the comma-separated parts to time, '
                    f'of {",".join(TREE_PARTS)} (default: all)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('kernel_times: torch.cuda.is_available() is false; this needs '
              'an NVIDIA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # the harness of this checkout, whatever tree is timed
    import benchmark_torch.harness.roofline  # noqa: F401
    import benchmark_torch.harness.trace  # noqa: F401
    device_line()
    if args.tree:
        parts = args.parts.split(',')
        check(set(parts) <= set(TREE_PARTS), ('--parts', parts))
        return time_tree(args.tree, parts)
    from brainevent_torch.ops import cuda_build
    cuda_build.library()
    print(f'kernel library ready (nvcc {cuda_build.last_build_seconds()!r} s)')
    return time_kernels_line(torch.device('cuda:0'))


if __name__ == '__main__':
    sys.exit(main())
