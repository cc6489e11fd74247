# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The shared parts of the card tests (``tests/test_torch_cuda.py``):
routes run explicitly, twins run on the card, the public entries' dtype
matrix, and the shards of the multi-device layer in one process.

This module imports ``torch``, ``numpy`` and ``brainevent_torch`` only:
the card's machine has no JAX, and its tests run with ``--noconftest``.
"""

import contextlib

import numpy as np
import torch

import brainevent_torch as bt
from brainevent_torch.models import networks as nw
from brainevent_torch.ops import scatter as sc
from brainevent_torch.ops.core import REGISTRY

F32 = np.float32
# K1's buffers, in its argument order
ORDER = ('v', 't_last', 'g_e', 'g_i', 'counts', 'spike_count', 'ids', 'n_ids')


def fields(state):
    """The five arrays of an ``EINetState``, in ``einet_pallas_sim``'s order."""
    return (state.neurons.v, state.neurons.t_last, state.g_e, state.g_i,
            state.spike_count)


def twin_ops():
    """``EINet._simulate``'s keywords for the twin loop on the card."""
    return dict(step_op=nw.einet_step_twin,
                scatter_op=sc.event_count_scatter_twin)


def k1k2_ops():
    """``EINet._simulate``'s keywords for the loop of K1 and K2, two
    launches a step: the route K21 replaced, run explicitly."""
    return dict(step_op=nw.einet_step, scatter_op=sc.event_count_scatter)


def step_buffers(rng, num, device):
    """K1's buffers with random contents (*rng* a numpy ``Generator``): v
    around threshold, t_last within a few steps of the refractory
    boundary at step 777, pending counts; and the step's time."""
    step = 777
    back = rng.integers(45, 56, num)
    t_last = (np.maximum(step - back, 0).astype(F32) * F32(0.1)).astype(F32)
    t_last[rng.random(num) < 0.2] = F32(-1e7)
    arrays = dict(
        v=rng.uniform(-70.0, -49.0, num).astype(F32), t_last=t_last,
        g_e=rng.uniform(0.0, 3.0, num).astype(F32),
        g_i=rng.uniform(0.0, 20.0, num).astype(F32),
        counts=rng.integers(0, 6, (2, num)).astype(np.int32),
        spike_count=rng.integers(0, 50, num).astype(np.int32),
        ids=np.zeros(num, np.int32), n_ids=np.zeros(2, np.int32))
    return ({k: torch.from_numpy(a).to(device) for k, a in arrays.items()},
            float(F32(step) * F32(0.1)))


@contextlib.contextmanager
def twins_on_card(ops):
    """Run *ops* through their twins on CUDA tensors for the length of the
    block (a reference run; twin calls are not launches)."""
    saved = {op: op.cuda for op in ops}
    for op in ops:
        op.cuda = lambda op_, *a, **k: op_.twin(*a, **k)
    try:
        yield
    finally:
        for op, fn in saved.items():
            op.cuda = fn


def within(got, want, bound, what=''):
    """``|got - want| <= 1e-5 * bound`` elementwise; the largest error."""
    torch.cuda.synchronize()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all()), what
    return float((got - want).abs().max()) if got.numel() else 0.0


def ordered_event_mm(w, s, transpose):
    """K16's function as the loop its sums follow: ``Y += W[:, i] *
    g(S[i])`` (``W[i, :]`` with *transpose*) over the k rows ``i`` in
    ascending order; with ``S`` one column, K15's ``s @ W``. Each product
    is exact (the gate is 0 or 1), so each add rounds once; a row without
    an event adds zeros to sums that are never -0.0, so it is left out."""
    from brainevent_torch.dense import pallas_kernels as dk
    g = dk.product_gate(s, w.dtype)
    m = w.shape[1] if transpose else w.shape[0]
    Y = torch.zeros(m, s.shape[1], dtype=w.dtype, device=w.device)
    for i in torch.nonzero(g.any(dim=1)).flatten().tolist():
        Y += (w[i, :, None] if transpose else w[:, i, None]) * g[i, None, :]
    return Y


def run_strategy(net, state, n_steps, strategy, ref, inp=20.0):
    """``einet_pallas_sim(strategy=...)`` from *state*, held against *ref*
    (five outputs): all five bitwise; every name, dense included (K21's
    table instance), launches K21 once, and K1, K2 and K19 never run.
    Returns the outputs."""
    bt.reset_launch_counts()
    out = bt.einet_pallas_sim(net, state, n_steps, inp, strategy=strategy)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert (counts['einet_sim'], counts['einet_step'],
            counts['einet_dense_hits'], counts['event_count_scatter']) == (
        1, 0, 0, 0), (strategy, counts)
    for x, y in zip(out, ref):
        assert x.dtype == y.dtype and torch.equal(x, y), strategy
    return out


# -- the dtypes the public entries take (ops/operand.py) -----------------------------

def c8_entries(device, gen, w_dtype):
    """``name -> (fn(spikes), spike shape, op name, nonzero gate, fn over
    |W| in float32 or None where the result is exact)`` for each public
    entry of K5-K8, K10, K12, K13 and K15-K18, weights in *w_dtype*."""
    n, m, b = 2000, 1500, 16
    on = torch.rand(n, m, generator=gen, device=device) < 0.02
    A = torch.where(on, torch.randn(n, m, generator=gen, device=device), 0.0)
    csr = bt.CSR.fromdense(A)
    idx = torch.randint(0, m, (n, 32), generator=gen, device=device,
                        dtype=torch.int32)
    w_ell = torch.randn(n, 32, generator=gen, device=device)
    W = torch.randn(n, m, generator=gen, device=device)
    trace = torch.rand(m, generator=gen, device=device)

    def w(x, d):
        return x.abs() if d is None else x.to(d)

    def ent(fn, shape, op, nonzero=False, exact=False):
        return (lambda s: fn(s, w_dtype), shape, op, nonzero,
                None if exact else (lambda s: fn(s, None)))
    return {
        # the scatters (K5, K8) add float weights with atomics in no fixed
        # order; a homogeneous weight counts in int32, exactly
        'binary_fcnmv T': ent(lambda s, d: bt.binary_fcnmv(
            w(w_ell[0, :1], d), idx, s, shape=(n, m), transpose=True), (n,),
            'fcn_event_scatter'),
        'binary_fcnmv': ent(lambda s, d: bt.binary_fcnmv(
            w(w_ell, d), idx, s, shape=(n, m)), (m,), 'fcn_event_gather'),
        'binary_csrmv': ent(lambda s, d: bt.binary_csrmv(
            w(csr.data, d), csr.indices, csr.indptr, s, shape=csr.shape),
            (m,), 'csr_gather_mv'),
        'binary_csrmv T': ent(lambda s, d: bt.binary_csrmv(
            w(csr.data[:1], d), csr.indices, csr.indptr, s, shape=csr.shape,
            transpose=True), (n,), 'csr_scatter_mv'),
        'binary_csrmm': ent(lambda s, d: bt.binary_csrmm(
            w(csr.data, d), csr.indices, csr.indptr, s, shape=csr.shape),
            (m, b), 'csr_gather_mm'),
        'binary_jitnmv': ent(lambda s, d: bt.binary_jitnmv(
            0.6, 0.06, 0.01, s, 3, shape=(n, m)), (m,), 'jitc_walk_mv'),
        'binary_jitnmm': ent(lambda s, d: bt.binary_jitnmm(
            0.6, 0.06, 0.01, s, 3, shape=(n, m)), (m, b), 'jitc_walk_mm4'),
        'binary_densemv T': ent(lambda s, d: bt.binary_densemv(
            w(W, d), s, transpose=True), (n,), 'dense_event_mv'),
        'binary_densemv': ent(lambda s, d: bt.binary_densemv(
            w(W, d), s, transpose=False), (m,), 'dense_event_mv'),
        'binary_densemm': ent(lambda s, d: bt.binary_densemm(
            w(W, d), s, transpose=False), (m, b), 'dense_event_mm'),
        'update_dense_on_binary_pre': ent(
            lambda s, d: bt.update_dense_on_binary_pre(
                w(W, d), s, trace, -1.0, 1.0), (n,), 'dense_stdp_pre', True,
            True),
        'update_dense_on_binary_post': ent(
            lambda s, d: bt.update_dense_on_binary_post(
                w(W, d).T.contiguous(), trace, s, -1.0, 1.0), (n,),
            'dense_stdp_post', True, True),
        'binary_2d_csr_row_count': ent(
            lambda s, d: bt.binary_2d_csr_row_count_p_call(s)[0], (n, b),
            'event_row_count', True, True),
    }


C8_SPIKE_DTYPES = (torch.bool, torch.int8, torch.uint8, torch.int32,
                   torch.int64, torch.float16, torch.bfloat16, torch.float32,
                   torch.float64)


def c8_spikes(dtype, shape, gen, device):
    """Spikes of *dtype*: 2% positive, negatives and (floats) NaN among
    the silent entries."""
    u = torch.rand(shape, generator=gen, device=device)
    x = torch.where(u < 0.02, 2.0, torch.where(u < 0.2, -1.0, 0.0))
    if dtype == torch.uint8:
        x = x.clamp(min=0)
    x = x.to(dtype)
    if dtype.is_floating_point:
        x.view(-1)[::13] = float('nan')
    return x


def c8_spike_dtypes(device, gen):
    """Spikes in the nine dtypes at every entry of :func:`c8_entries`:
    bitwise the bool spikes' result, through the kernel. Returns the
    number of cases."""
    n_checked = 0
    for name, (fn, shape, op, nonzero, _) in c8_entries(
            device, gen, torch.float32).items():
        for dtype in C8_SPIKE_DTYPES:
            s = c8_spikes(dtype, shape, gen, device)
            gate = s if dtype == torch.bool else (s != 0 if nonzero
                                                  else s > 0)
            want = fn(gate)
            before = REGISTRY[op].launches
            got = fn(s)
            torch.cuda.synchronize()
            assert REGISTRY[op].launches == before + 1, (name, dtype)
            assert got.dtype == want.dtype and torch.equal(got, want), (
                name, dtype)
            n_checked += 1
    return n_checked


def c8_weighted(device, gen, dtype):
    """The entries of :func:`c8_entries` with weights of their own."""
    return {name: e for name, e in c8_entries(device, gen, dtype).items()
            if 'jitn' not in name and 'row_count' not in name}


def c8_half_weights(device, gen):
    """float16 and bfloat16 weights: one launch of the float32 kernel, the
    result in the weights' dtype, within 1 ulp of it of the twin on the
    widened weights plus the float32 bound. Returns the largest error
    per dtype."""
    worst = {}
    for dtype in (torch.float16, torch.bfloat16):
        for name, (fn, shape, op, nonzero, fn_abs) in c8_weighted(
                device, gen, dtype).items():
            s = c8_spikes(torch.bool, shape, gen, device)
            before = REGISTRY[op].launches
            got = fn(s)
            launched = REGISTRY[op].launches - before
            with twins_on_card([REGISTRY[op]]):
                want = fn(s)
            torch.cuda.synchronize()
            assert got.dtype == dtype == want.dtype, (name, dtype)
            assert launched == 1, (name, dtype, launched)
            g, t = got.float(), want.float()
            tol = torch.finfo(dtype).eps * torch.maximum(g.abs(), t.abs())
            if fn_abs is not None:
                tol = tol + 1e-5 * fn_abs(s)
            assert bool(((g - t).abs() <= tol).all()), (name, dtype)
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0),
                                    float((g - t).abs().max()))
    return worst


def c8_float64_weights(device, gen):
    """float64 weights on the card (C10): one launch of the kernel's
    ``double`` instance at each weighted entry of :func:`c8_entries`, the
    result float64 and within ``1e-12 * sum|w| gate`` of the float64 twin
    (bitwise at the exact entries). Returns the number of entries and the
    largest error."""
    worst = 0.0
    entries = c8_weighted(device, gen, torch.float64)
    for name, (fn, shape, op, nonzero, fn_abs) in entries.items():
        s = c8_spikes(torch.bool, shape, gen, device)
        worst = max(worst, c10_check(
            name, lambda: fn(s), REGISTRY[op],
            None if fn_abs is None else (lambda: fn_abs(s).double())))
    return len(entries), worst


def c10_check(name, fn, op, fn_abs):
    """``fn()`` launches *op*'s double instance once, returns float64, and
    is within ``1e-12 * fn_abs()`` of the float64 twin (bitwise where
    *fn_abs* is None). Returns the largest error."""
    before = op.launches
    got = fn()
    launched = op.launches - before
    with twins_on_card([op]):
        want = fn()
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 == want.dtype, (name, got.dtype)
    assert launched == 1, (name, 'float64', launched)
    err = (got - want).abs()
    if fn_abs is None:
        assert torch.equal(got, want), (name, 'float64 bitwise')
    else:
        assert bool((err <= 1e-12 * fn_abs()).all()), (
            name, 'float64', float(err.max()))
    return float(err.max())


def c10_float_products(device, gen):
    """The float64 kernels the binary matrix does not reach: ``csrmv``
    both ways and ``csrmm`` (K7, K8, K10 on a float64 operand), the CSR
    STDP update and a weight gradient (K9), each one launch of its
    ``double`` instance against the float64 twin: K9 bitwise, the sums
    within ``1e-12 * sum|w x|``. Returns the number of cases and the
    largest error."""
    n, m, b = 2000, 1500, 16
    f64 = torch.float64
    on = torch.rand(n, m, generator=gen, device=device) < 0.02
    A = torch.where(on, torch.randn(n, m, generator=gen, device=device,
                                    dtype=f64), 0.0)
    csr = bt.CSR.fromdense(A)
    w, args, shape = csr.data, (csr.indices, csr.indptr), csr.shape
    v = {k: torch.randn(k, generator=gen, device=device, dtype=f64)
         for k in (n, m)}
    X = torch.randn(m, b, generator=gen, device=device, dtype=f64)
    s = torch.rand(n, generator=gen, device=device) < 0.1
    trace = torch.rand(m, generator=gen, device=device, dtype=f64)

    def grad():
        wg = w.clone().requires_grad_(True)
        y = bt.binary_csrmv(wg, *args, s, shape=shape, transpose=True)
        (y * v[m]).sum().backward()
        return wg.grad

    cases = {
        'csrmv': (lambda: bt.csrmv(w, *args, v[m], shape=shape),
                  'csr_gather_mv',
                  lambda: bt.csrmv(w.abs(), *args, v[m].abs(), shape=shape)),
        'csrmv T': (lambda: bt.csrmv(w, *args, v[n], shape=shape,
                                     transpose=True), 'csr_scatter_mv',
                    lambda: bt.csrmv(w.abs(), *args, v[n].abs(), shape=shape,
                                     transpose=True)),
        'csrmm': (lambda: bt.csrmm(w, *args, X, shape=shape),
                  'csr_gather_mm',
                  lambda: bt.csrmm(w.abs(), *args, X.abs(), shape=shape)),
        'update_csr_on_binary_pre': (lambda: bt.update_csr_on_binary_pre(
            w, *args, s, trace, -1.0, 1.0, shape=shape), 'pair_gather',
            None),
        'binary_csrmv weight grad': (grad, 'pair_gather', None),
    }
    worst = 0.0
    for name, (fn, op, fn_abs) in cases.items():
        worst = max(worst, c10_check(name, fn, REGISTRY[op], fn_abs))
    return len(cases), worst


def c13_c14_scatter(device, gen):
    """``event_scatter_add`` on the card in the dtypes of C13 and C14:
    100k events (targets in [-5, 55), some out of range, a mask) into 50
    targets, one launch of K2's value form each. float64 values of scale
    ~1e3 sum in float64, within ``1e-12 * sum|v|`` per target of the
    float64 twin; int32 and int64 bitwise the twin; int8, int16 and uint8
    sum in the int32 instance and equal ``index_add_`` in their own dtype
    on the CPU, wraparound included. Returns the cases and the largest
    error."""
    n, n_out = 100_000, 50
    targets = torch.randint(-5, n_out + 5, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    mask = torch.rand(n, generator=gen, device=device) < 0.9
    cases = {
        torch.float64: torch.randn(n, generator=gen, device=device,
                                   dtype=torch.float64) * 1e3,
        torch.int32: torch.randint(-2 ** 30, 2 ** 30, (n,), generator=gen,
                                   device=device, dtype=torch.int32),
        torch.int64: torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen,
                                   device=device, dtype=torch.int64),
        torch.int8: torch.randint(-128, 128, (n,), generator=gen,
                                  device=device).to(torch.int8),
        torch.int16: torch.randint(-2 ** 15, 2 ** 15, (n,), generator=gen,
                                   device=device).to(torch.int16),
        torch.uint8: torch.randint(0, 256, (n,), generator=gen,
                                   device=device).to(torch.uint8)}
    op = sc.event_scatter_float
    worst = 0.0
    for dtype, values in cases.items():
        before = op.launches
        got = bt.event_scatter_add(targets, values, n_out, mask=mask)
        torch.cuda.synchronize()
        assert op.launches - before == 1 and got.dtype == dtype, dtype
        with twins_on_card([op]):
            want = bt.event_scatter_add(targets, values, n_out, mask=mask)
        keep = mask & (targets >= 0) & (targets < n_out)
        cpu = torch.zeros(n_out, dtype=dtype).index_add_(
            0, targets[keep].long().cpu(), values[keep].cpu())
        if dtype.is_floating_point:
            err = float((got - want).abs().max())
            scale = torch.zeros(n_out, dtype=dtype, device=device).index_add_(
                0, targets[keep].long(), values[keep].abs())
            assert bool(((got - want).abs() <= 1e-12 * scale).all()), err
            worst = max(worst, err)
        else:
            assert torch.equal(got, want) and torch.equal(got.cpu(), cpu), (
                dtype)
    return len(cases), worst


# -- the multi-device layer in one process: K20, K22, ShardedEINet ------------------

def shard_lists(ids, n_act, num, n_dev, device):
    """The spike list *ids* (its first *n_act* global ids) cut into
    *n_dev* local lists of ``num / n_dev`` neurons: ``[(ids_r, n_r)]``."""
    n_loc = num // n_dev
    sel = ids[:n_act].long()
    sel = sel[(sel >= 0) & (sel < num)]
    out = []
    for r in range(n_dev):
        loc = sel[(sel >= r * n_loc) & (sel < (r + 1) * n_loc)] - r * n_loc
        ids_r = torch.zeros(n_loc, dtype=torch.int32, device=device)
        ids_r[:loc.numel()] = loc.to(torch.int32)
        out.append((ids_r, torch.tensor([loc.numel()], dtype=torch.int32,
                                        device=device)))
    return out


def k20_vs_k2(net, ids, n_ids, device, n_dev=4):
    """K20 on *n_dev* shards of *net* for one spike list: each shard's
    full partial bitwise its twin, their sum and the shard-major buffer
    bitwise K2's counts. Returns the largest error against the twin."""
    from brainevent_torch.parallel import mega
    num, n_loc = net.num, net.num // n_dev
    k2 = sc.event_count_scatter(ids, n_ids, net.conn_all, net.n_exc,
                                torch.zeros(2, num, dtype=torch.int32,
                                            device=device))
    total = torch.zeros(2, num, dtype=torch.int32, device=device)
    major = torch.zeros(n_dev, 2, n_loc, dtype=torch.int32, device=device)
    worst = 0.0
    for r, (ids_r, n_r) in enumerate(shard_lists(ids, int(n_ids), num,
                                                 n_dev, device)):
        conn_r = net.conn_all[r * n_loc:(r + 1) * n_loc]
        got = mega.mega_counts(ids_r, n_r, conn_r, r * n_loc, net.n_exc,
                               torch.zeros(1, 2, num, dtype=torch.int32,
                                           device=device))
        want = mega.mega_counts_twin(ids_r, n_r, conn_r, r * n_loc,
                                     net.n_exc, torch.zeros_like(got))
        mega.mega_counts(ids_r, n_r, conn_r, r * n_loc, net.n_exc, major)
        torch.cuda.synchronize()
        worst = max(worst, float((got - want).abs().max()))
        assert torch.equal(got, want), ('K20 vs twin', num, r)
        total += got[0]
    torch.cuda.synchronize()
    assert torch.equal(total, k2), ('K20 shards summed vs K2', num)
    assert torch.equal(major.transpose(0, 1).reshape(2, num), k2), (
        'K20 shard-major vs K2', num)
    return worst


def local_counts_vs_k2(net, ids, n_ids, device, n_dev=4):
    """``mega_local_counts``, K20's package entry, on each of *n_dev*
    shards of one spike list of *net* (as bool spikes): the shards'
    float32 partials summed bitwise K2's counts. Returns K20's launches,
    one a shard."""
    from brainevent_torch.parallel import mega
    num, n_loc = net.num, net.num // n_dev
    k2 = sc.event_count_scatter(ids, n_ids, net.conn_all, net.n_exc,
                                torch.zeros(2, num, dtype=torch.int32,
                                            device=device))
    spike = torch.zeros(num, dtype=torch.bool, device=device)
    spike[ids[:int(n_ids)].long()] = True
    layout = mega.MegaScatterLayout(net.conn_all, net.n_exc, num)
    total = torch.zeros(2, num, device=device)
    bt.reset_launch_counts()
    for r in range(n_dev):
        rows = slice(r * n_loc, (r + 1) * n_loc)
        e, i = mega.mega_local_counts(spike[rows], layout.conn_flat[rows],
                                      layout=layout, row0=r * n_loc)
        total[0] += e
        total[1] += i
    torch.cuda.synchronize()
    assert torch.equal(total, k2.float()), ('mega_local_counts vs K2', num)
    return bt.launch_counts()['mega_counts']


def indegree_net(device):
    """A 4k network whose target 17 has an in-degree of 300 from each
    class (the case the JAX mega-kernel refuses above 255)."""
    rng = np.random.default_rng(290)
    conn = rng.integers(0, 4000, (4000, 80)).astype(np.int32)
    conn[:300, 0] = 17
    conn[3200:3500, 0] = 17
    return bt.EINet(scale=1.0, conn_all=conn, device=device)


SHARD_FLAGS = ((0, 0, 1), (1, 1, 1), (0, 1, 1), (1, 1, 0))  # parity, fold, step


def shard_buffers(net, n_dev, r, seed, device):
    """Shard *r* of *n_dev* of a random step state of *net*
    (:func:`step_buffers` from *seed*): its ``n_loc`` neurons' K1
    buffers, its rows of conn, the row parameters ``p`` and ``row0``, and
    the step's time."""
    bufs, t = step_buffers(np.random.default_rng(seed), net.num, device)
    n_loc = net.num // n_dev
    row0 = r * n_loc
    loc = {k: (b[:, row0:row0 + n_loc] if k == 'counts'
               else b[row0:row0 + n_loc]).contiguous()
           for k, b in bufs.items() if k != 'n_ids'}
    loc['n_ids'] = torch.zeros(2, dtype=torch.int32, device=device)
    p = net.step_params()
    p.num = n_loc
    conn = net.conn_all[row0:row0 + n_loc]
    return loc, conn, p, row0, t


def k22_vs_k1_k20(net, device, n_dev=1, seed=0):
    """K22 on each of *n_dev* shards of a random step state of *net*, for
    each of :data:`SHARD_FLAGS`: its five state arrays and both parities
    of its partials bitwise one K1 step, a memset and K20 on the same
    shard (and the twin's, its counts left as they were), the other
    parity zeroed; on a step the shards' partials summed bitwise K2 over
    the whole net's spikes. Returns the largest error against the
    twin."""
    from brainevent_torch.parallel import mega
    num, n_loc = net.num, net.num // n_dev
    worst = 0.0
    for k, (parity, fold, step) in enumerate(SHARD_FLAGS):
        total = torch.zeros(n_dev, 2, n_loc, dtype=torch.int32, device=device)
        for r in range(n_dev):
            loc, conn, p, row0, t = shard_buffers(net, n_dev, r, seed + k,
                                                  device)
            # the parent's step: K1, a memset of the partials, K20
            k1 = {n: b.clone() for n, b in loc.items()}
            nw.einet_step(*(k1[n] for n in ORDER), p, t, parity, fold, step)
            full = torch.zeros(n_dev, 2, n_loc, dtype=torch.int32,
                               device=device)
            if step:
                mega.mega_counts(k1['ids'], k1['n_ids'][parity:parity + 1],
                                 conn, row0, net.n_exc, full)
            args = []
            for _ in range(2):
                b = {n: x.clone() for n, x in loc.items()}
                partials = torch.full((2, n_dev, 2, n_loc), 5,
                                      dtype=torch.int32, device=device)
                partials[parity].zero_()
                args.append((b, partials))
            (kb, kp), (tb, tp) = args
            names = ('v', 't_last', 'g_e', 'g_i', 'counts', 'spike_count')
            mega.einet_shard_step(*(kb[n] for n in names), kp, conn, row0,
                                  net.n_exc, p, t, parity, fold, step)
            mega.einet_shard_step_twin(*(tb[n] for n in names), tp, conn,
                                       row0, net.n_exc, p, t, parity, fold,
                                       step)
            torch.cuda.synchronize()
            for n in ('v', 't_last', 'g_e', 'g_i', 'spike_count'):
                worst = max(worst, float((kb[n] - tb[n]).abs().max()))
                assert torch.equal(kb[n], tb[n]), ('K22 vs twin', num, r, n)
                assert torch.equal(kb[n], k1[n]), ('K22 vs K1', num, r, n)
            assert torch.equal(kb['counts'], loc['counts']) and torch.equal(
                tb['counts'], loc['counts']), ('K22 leaves the counts', num)
            assert torch.equal(kp, tp), ('K22 partials vs twin', num, r)
            if step:
                assert torch.equal(kp[parity], full) and int(
                    kp[parity ^ 1].abs().sum()) == 0, ('K22 vs K20', num, r)
                total += kp[parity]
            else:
                assert bool((kp[parity ^ 1] == 5).all()), (
                    'a fold alone leaves the partials', num, r)
        if step:
            bufs, t = step_buffers(np.random.default_rng(seed + k), num,
                                   device)
            p = net.step_params()
            nw.einet_step(*(bufs[n] for n in ORDER), p, t, parity, fold, step)
            k2 = sc.event_count_scatter(
                bufs['ids'], bufs['n_ids'][parity:parity + 1], net.conn_all,
                net.n_exc, torch.zeros(2, num, dtype=torch.int32,
                                       device=device))
            torch.cuda.synchronize()
            assert torch.equal(total.transpose(0, 1).reshape(2, num), k2), (
                'K22 shards summed vs K2', num, n_dev)
    return worst


def neuron_mesh_world1(device, store):
    """The process group of this one process (NCCL on the card, through a
    file store in the directory *store*: no TCP port) and a 1-D neuron
    mesh over it."""
    import torch.distributed as dist
    from brainevent_torch.parallel import neuron_mesh
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            init_method=f'file://{store}/pg', rank=0,
                            world_size=1)
    return neuron_mesh(1, device_type=device.type)


def parent_sharded_run(snet, state, n_steps, inp=20.0):
    """The route K22 replaced, on this rank: ``einet_loop`` over K1 and,
    a step, a memset of the ``(n_dev, 2, n_loc)`` partials, K20 and one
    ``reduce_scatter_tensor``, composed here from the package's parts
    (three launches and a collective a step). Returns the five local
    arrays."""
    import torch.distributed as dist
    from brainevent_torch.parallel import mega
    full = torch.empty(snet.n_dev, 2, snet.n_loc, dtype=torch.int32,
                       device=snet.device)

    def propagate(ids, n_ids, counts):
        full.zero_()
        mega.mega_counts(ids, n_ids, snet.indices_loc, snet.row0,
                         snet.n_exc, full)
        dist.reduce_scatter_tensor(counts.view(-1), full.view(-1),
                                   group=snet._axis.group)
    return nw.einet_loop(*(x.to_local() for x in state),
                         snet.times(n_steps), snet.step_params(inp),
                         propagate)
