# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Smoke test of brainevent_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``brainevent_torch/csrc`` and drives the
port's three paths: the COBA EI network (Brette et al. 2007) at 4,000
neurons through ``einet_pallas_sim`` (kernel K21, the whole run in one
launch; K1 and K2 above its capacity); the
surrogate-gradient train step of a 100k-neuron, 10M-synapse recurrent
network through ``train_step`` (K3, K4; K5 with ``forward='event'``),
beside the 10M-synapse event product ``binary_fcnmv`` (K5, K6); the
CSR slice (``CSR``, ``BinaryArray``, STDP, mat-mat products) at 10k x 10k
with 10% connectivity, 10M entries (K7-K10); and the JITC slice, the
80k-neuron ``JITCNet`` over implicit connectivity and the JITC matrix
classes (K11-K14); the dense slice, a 10k x 10k ``Dense`` matrix
(100M weights) with ``BinaryArray`` products, STDP and the event
encoders (K15-K18); and the EI strategies of ``einet_pallas_sim``, the
dense one over the ``(num, num)`` connection-count table (K21's table
instance; K1 + K19 above its capacity) and the superseded ones (K21); and
the multi-device layer over ``torch.distributed`` at world size 1 under
NCCL (the one process's group, through a file store): ``ShardedEINet`` at
4k and 400k (K22, one launch and one reduce-scatter a step), K20 and K22
split over four shards in one process, and the sharded ops (K5-K10,
K11/K12 with a row offset). Phases:

1. the device (``torch.cuda.get_device_name`` and ``nvidia-smi``);
2. the kernel build, with its seconds;
3. K1 (``einet_step``, whose fold and update are ``einet_neuron.cuh``'s,
   shared with K21) against its PyTorch twin on the card, on random
   states across the refractory boundary, COBA and CUBA, 4k and 400k
   neurons: bitwise equal;
4. K2 (``event_count_scatter``, and its float form) against its twin on
   random spike lists, up to every neuron spiking at once: equal;
5. the EI slice: COBA and CUBA at 4k, COBA at 40k (the size from which
   the JAX package takes its mxu6 route) and 400k for 2,000 steps through
   K21 (``einet_sim``), against the twin loop and the K1 + K2 loop on the
   same card and inputs: all five outputs bitwise; K21 launched once per
   run, K1 and K2 never; firing rate within 5-200 Hz; then a network
   above K21's capacity (``einet_sim_capacity``) through ``EINet.run`` on
   K1 (2,001 launches) and K2 (2,000), bitwise the twin loop;
6. EI timing, for the record: 4k COBA over 100k steps and 400k COBA over
   5,000 steps in us/step (host clock) through K21 and through the K1 + K2
   loop in turns, the K1 + K2 loop of 2,000 steps captured in one CUDA
   graph (replayed), K21's device time for each NPT instance whose grid
   fits and its bare barrier loop (the same grid, one barrier a step);
   where K21 runs its cluster instance (4k), that instance's device time
   and the bare ``cluster.sync()`` loop of clusters of 2-16 blocks, each
   block shaped as the instance's;
   K1's and K2's device time (CUDA events around launches queued back to
   back), host-paced time per launch, and their twins' time per call;
   K21's line: one launch of 2,000 steps at 4k, device ms, twin ms;
7. K3 (``plan_gather_mv``, over each plan's row index with row-order
   weights) and K4 (``plan_matvec_dw``, with and without that row view)
   against their twins on both plans of the 100k x 100 model, x normal
   and 0/1 at 18%: y within 1e-5 * sum|w x| per row, K3 bitwise K4's y
   and ``gather_matvec``'s, K4's dw bitwise (0 at padding), K4 with the
   view bitwise without it, repeats bitwise;
8. K5 (``fcn_event_scatter``) and K6 (``fcn_event_gather``) against their
   twins at 100k x 100, rates 0, 0.1%, 1% and 100%, homogeneous and
   heterogeneous weights, bool and float spikes: homogeneous exact, K5
   heterogeneous within 1e-5 * sum|w| per target, K6 within 1e-6 * sum|w|
   per row; then ``binary_fcnmv`` driven at 0.1% and 1% in both
   directions;
9. the training slice, small (12-128-4, T 20), ``forward='plan'`` and
   ``'event'``: spikes, loss, gradients and 10 train steps through the
   kernels against the twin route on the same card;
10. the training slice at full width (100k hidden, 100 connections, T 50):
    one warm-up and five timed train steps, 50 K3 and 50 K4 launches per
    step, loss and gradients bitwise equal over two runs, one profiled
    step (device busy time and the largest kernels), and one step with
    ``forward='event'`` (50 K5 launches);
11. learning: the 2,000-neuron net of 4 class-templated inputs, 30 epochs
    at lr 0.5, must lower its loss;
12. K3-K6 timing at full width: device ms per launch and twin ms per call
    (K5 and K6 at 0.1% and 1%; K4 with the row view, as the train step
    calls it, and without), and the row-order weight views K3 and K4 read
    (one gather each per train step) apart;
13. K7 (``csr_gather_mv``) and K8 (``csr_scatter_mv``) against their twins
    at (10k, 10k, 10%): rates 0, 0.1%, 1%, 10% and 100%, homogeneous and
    heterogeneous weights, bool and float spikes, the indexed (``perm``)
    and float variants; homogeneous binary exact, the others within
    1e-5 * sum|w op(x)| per output, K7 bitwise on a repeat;
14. K9 (``pair_gather``) against its twin at 10M entries: both sides, one
    side, ``-1`` sentinels, and the STDP updates with clip: bitwise;
15. K10 (``csr_gather_mm``) against its twin at (10k, 10k, 1%, B = 256):
    ``csrmm`` and ``binary_csrmm`` both directions, and ``gather_matmat``
    over an mm plan: within 1e-5 * sum|w x|, bitwise the stored-order sum
    (``csr_gather_mm_ordered``), bitwise on a repeat; the CSR slice's
    ``W @ X`` and ``X @ W`` at (10k, 10k, 10%, B = 16) within tolerance
    and bitwise the stored-order sum; the per-call CSC mirror of a
    functional transposed product, timed;
16. the CSR slice at 10M entries: 100 steps of ``BinaryArray @ W``,
    ``W @ BinaryArray``, trace decay, ``update_on_pre``/``update_on_post``
    with clip, ``W @ X`` and ``X @ W``, through the kernels and through the
    twins on the card: ``W.data`` bitwise, products within 1e-5 relative,
    K7, K8 once and K9, K10 twice per step; a backward through ``W @ v``;
    ``W @ X`` at B = 256;
17. K7-K10 timing: device ms per launch and twin ms per call (K7 and K8
    at 0.1% and 1%); K10 at the csrmm cell (NT and over its mm plan) and
    at the slice's B = 16 both ways, each beside ``torch.sparse.mm``;
    K9 beside ``torch.sparse.sampled_addmm`` on W's pattern (equal);
18. K11-K14 (``jitc_walk_setup``, ``jitc_walk_mv``, ``jitc_walk_mm``/
    ``jitc_walk_mm4``, ``jitc_walk_todense``/``jitc_walk_todense4``)
    against their twins at (5120, 5120, 1%), each weight law, strides 32
    and 4, ``corder`` True and False, event and float operands, B = 16 and
    256: K11 and K14 bitwise, products within 1e-5 * sum|w x|, gathers
    bitwise on a repeat; then the class surface (``M @ v``, ``v @ M``,
    ``plan @ B``, ``M @ B``, ``X @ M``, ``todense``) against the dense
    matrices;
19. the JITC slice: ``JITCNet`` at 80k (scale 20) and 4k, normal law,
    COBA, 2,000 steps through K12 (one launch per projection per step),
    20 sampled steps against the twin route (spikes bitwise, drives within
    1e-5 relative), the rate in 1-200 Hz; the scalar law at 80k over 1,000
    steps, spike counts equal to the twin loop on the card;
20. JITC timing: us/step at 4k and 80k, device ms per launch of K11-K14
    and their twins' ms per call, K12 at the 80k E projection over the
    plan and drawing its own setup (the event scatter at the recorded
    spikes, 10% and 100%, the gather and the float scatter), and 10
    profiled steps at 80k;
21. K15 (``dense_event_mv``) against its twin at (10k, 10k), both
    directions, rates 0, 0.1%, 1%, 10% and 100%, bool and float spikes
    (negatives and NaN among the silent ones), and K16
    (``dense_event_mm``) at (5000, 5000, B = 128) and (10k, 10k, B = 128)
    at 1%, both directions: within 1e-5 * sum|W| gate per output,
    bitwise on a repeat; K15's ``s @ W`` bitwise the ascending-row loop at
    each rate; K16 bitwise the ascending-k loop
    (``ordered_event_mm``) at (5000, 5000, B = 128), 1% and 50%, bool and
    float, both directions;
22. K17 (``dense_stdp_pre``/``dense_stdp_post``) at (10k, 10k), 1%
    spikes, with and without the clip, and K18 (``event_row_count``) at
    (10k, 128) and (16, 8192) at 1%, against their twins: bitwise; the
    seven PyTorch encoders on the card equal to their CPU results;
23. the dense slice at (10k, 10k): 100 steps of ``BinaryArray(pre) @ W``
    and ``W @ BinaryArray(post)`` at 1%, trace decay, ``update_on_pre``/
    ``update_on_post`` with clip [-1, 1], ``W @ BinaryArray(S)`` (B =
    128) and the encoders of ``S``, through the kernels and through the
    twins on the card: ``W.data`` bitwise, products within 1e-5 * sum|W|
    gate, K15 twice and K16, K17 (each direction), K18 once per step; a
    backward through ``W @ BinaryArray(float spikes)``; 10 profiled steps;
24. dense timing: device ms per launch of K15-K18 at the slice's shapes
    (K16 also at 10% and 50%, both directions), their twins' ms per call,
    their bounds and the library calls (``torch.matmul`` with TF32 off,
    ``torch.addr``, ``torch.count_nonzero``);
25. K19 (``einet_dense_hits``) against its twin and against K2 on the same
    spike lists (0, 1, 1% and 100% of the neurons, out-of-range ids among
    them) at 4k and 40k with uint8 tables and at 4k with an int32 table
    (a multiplicity above 255): exact, bitwise K2;
26. the strategies: ``einet_pallas_sim(strategy='dense')`` on COBA and
    CUBA 4k and COBA 40k for 2,000 steps, all five outputs bitwise the
    ``'mxu3'`` route's, one K21 launch (its table instance) and no K1, K2
    or K19, the rate in 5-200 Hz, the table's bytes and build time; the
    same runs on the parent's route, the loop of K1 and K19
    (``dense_k19``: ``EINet._simulate`` with ``step_op=einet_step`` and
    the table, the route the package keeps above the table instance's
    capacity, a size no card's memory holds the table of): K1 2001 times
    and K19 2000 times, bitwise mxu3; an int32 table (a multiplicity
    above 255) and a burst (inp 500, 10 steps) on both routes; every other
    strategy name at 4k bitwise mxu3, one K21 launch each; the table
    instances' occupancy and capacity;
27. dense timing: COBA 4k over 100k steps and 40k over 20k, after 1,000,
    us/step of the dense strategy through K21's table instance and
    through K1 + K19 in turns, mxu3 beside; the table instance's device
    us/step for each NPT whose grid fits, and at NPT 1 by walk at 8k-30k
    (``time_walks``); K19's device ms per launch at 4k
    and 40k on recorded spike lists, its twin's ms, its bound, and
    ``torch.matmul`` of the ``(2, num)`` float32 masks with the float32
    table (TF32 off); the table instance's line: one launch of 2,000 steps
    at 4k against its twin;
28. the dtypes of the public entries of K5-K8, K10, K12, K13 and K15-K18:
    spikes in nine dtypes (negatives and NaN among the silent ones) give
    the bool spikes' result bitwise through the kernel; float16 and
    bfloat16 weights within 1 ulp of the twin plus the float32 bound;
    float64 weights (C10) through each kernel's ``double`` instance, one
    launch, within 1e-12 * sum|w x| of the float64 twin (bitwise where the
    float32 route is exact), and float64 ``csrmv``/``csrmm``, CSR STDP and
    a CSR weight gradient (K7-K10 on float64); ``event_scatter_add`` (K2's
    value form) with float64 values (C13; within 1e-12 * sum|v| per target
    of the float64 twin) and int32, int64, int8, int16 and uint8 outputs
    (C14; bitwise the twin, the narrow ones through the int32 instance and
    equal to ``index_add_`` in their own dtype on the CPU, wraparound
    included), one launch each;
29. K20 (``mega_counts``) on COBA 4k and 400k spike lists recorded from
    runs, split over 4 shards in one process (``row0 = r * n_loc``): each
    partial bitwise its twin, their sum and the shard-major buffer
    bitwise K2; a 4k table with an in-degree of 300 per class at one
    target (the JAX route refuses above 255), exact; at world size 1 (the
    main path's shape) one launch bitwise its twin, then K20's device ms,
    its twin's, its bound and ``index_add_``'s; ``mega_local_counts``, its
    package entry, on the 4k list's 4 shards (one K20 launch each), the
    shards summed bitwise K2; (29b) K22
    (``einet_shard_step``) on random step states at 4k and 400k, at world
    size 1 and over 4 shards, each parity, fold and step: the state and
    both parities of the partials bitwise its twin and one K1 step, a
    memset and K20 (``k22_vs_k1_k20``), the shards summed bitwise K2;
    K22's device ms per launch beside K1 + memset + K20's, its twin's ms
    and its bound;
30. ``ShardedEINet`` (world size 1, NCCL) at COBA 4k and 400k, both
    ``propagate`` routes, 2,000 steps: all five fields bitwise ``EINet``;
    K22 2,001 launches, K1, K20 and K2 none; exactly one
    ``reduce_scatter_tensor`` of ``2 * num * 4`` bytes per step and no
    other collective (counted by wrapping ``torch.distributed`` here);
    the parent's route (``parent_sharded_run``: K1, a memset and K20 a
    step) bitwise too, K1 2,001 and K20 2,000 launches; us/step over
    5,000 steps after 200, K22 and the parent's route in turns, beside
    ``EINet``;
31. the sharded ops at world size 1 against the single-device entries:
    ``sharded_binary_fcnmv`` (both weights, both directions, ``psum`` and
    ``psum_scatter``), the four CSR wrappers both ways and a weight
    gradient, bitwise (K5's and K8's float atomics within 1e-5 * sum|w x|);
    K11/K12 at the 80k E projection in halves with ``row0`` 0 and n/2:
    plans and gathers bitwise the whole walk, the scatter within 1e-5 *
    sum|w x|; ``sharded_jitmv`` bitwise ``jitnmv``.

With ``--tree DIR`` it only times DIR's ``brainevent_torch`` by this
file's code (``time_tree``), to compare two checkouts on one card: phase
17's K10 timing, phase 20's JITCNet and K12 timing, phase 24's K15 timing,
phase 10's train steps, phase 23's dense slice and phase 6's EI runs;
``--parts`` picks some of them.

Each kernel's line also carries its bound (the larger of its bytes over
the HBM rate and its operations over the float32 rate) and the time of one
PyTorch call computing the same function (``torch.sparse.mm``,
``torch.sparse.sampled_addmm``, ``index_add_``, ``torch.matmul``,
``torch.addr``, ``torch.count_nonzero``) where one exists. K5's and K8's is ``torch.sparse.mm`` of the transposed
matrix by the float spikes; their ``index_add_`` over the active rows'
targets, gathered outside the timed call, is printed beside it as what it
is, not the same function. Any failure exits non-zero; so does a host without
CUDA. The line before the last is ``{"kernels": [...]}`` (K1-K22 and K21's
table instance, ``einet_sim_table``; K1's and K2's launches are those of
the run above K21's capacity, K21's its one launch of the 4k COBA run, its
ms one launch of 2,000 steps; K15's line is its ``s @ W`` direction,
K10's the mean of the CSR slice's two B = 16 directions with each shape
apart under ``by_shape``; K19's launches the 4k COBA dense run above the
table instance's capacity, K20's the parent's 400k sharded route, the
table instance's the 4k COBA dense run, K22's the 400k sharded run); the
last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import contextlib
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

F32 = np.float32
_START = time.perf_counter()


def phase(name):
    """Print a phase's header with the seconds since the script started."""
    print(f'== {name} [{time.perf_counter() - _START:.1f} s]', flush=True)


def check(ok, what):
    """Fail the run when *ok* is false (unlike assert, kept under -O)."""
    if not ok:
        raise SystemExit(f'chip_smoke: FAILED: {what}')


def device_info():
    phase('1 device')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {name} count {torch.cuda.device_count()}')
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f'nvidia-smi failed: {smi.stderr.strip()}')
    return name


def random_step_state(num, seed, device):
    """K1 buffers with random contents: v around threshold, t_last within a
    few steps of the refractory boundary at step 1234, pending counts."""
    rng = np.random.default_rng(seed)
    step = 1234
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
    t = float(F32(step) * F32(0.1))
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}, t


ORDER = ('v', 't_last', 'g_e', 'g_i', 'counts', 'spike_count', 'ids', 'n_ids')


def check_k1(nets, device):
    phase('3 K1 einet_step vs twin (tolerance: bitwise, max|err| 0)')
    from brainevent_torch.models import networks as nw
    worst = 0.0
    for label, net in nets.items():
        for coba in (1, 0):
            p = net.step_params()
            p.coba = coba
            for seed, (parity, fold, step) in enumerate(
                    ((0, 1, 1), (1, 1, 1), (0, 0, 1), (1, 1, 0))):
                bufs, t = random_step_state(net.num, seed, device)
                ref = {k: b.clone() for k, b in bufs.items()}
                nw.einet_step(*(bufs[k] for k in ORDER), p, t, parity, fold,
                              step)
                nw.einet_step_twin(*(ref[k] for k in ORDER), p, t, parity,
                                   fold, step)
                torch.cuda.synchronize()
                for k in ('v', 't_last', 'g_e', 'g_i'):
                    worst = max(worst, float((bufs[k] - ref[k]).abs().max()))
                    check(torch.equal(bufs[k], ref[k]), (label, coba, k))
                for k in ('counts', 'spike_count', 'n_ids'):
                    check(torch.equal(bufs[k], ref[k]), (label, coba, k))
                n = int(ref['n_ids'][parity])
                got_ids = torch.sort(bufs['ids'][:n]).values
                check(torch.equal(got_ids, ref['ids'][:n]), (label, coba))
                print(f'{label} coba={coba} parity={parity} fold={fold} '
                      f'step={step}: equal, {n} spikes')
    return worst


def check_k2(nets, device):
    phase('4 K2 event_count_scatter vs twin (tolerance: exact)')
    from brainevent_torch.ops import scatter as sc
    rng = np.random.default_rng(1)
    worst = 0.0
    for label, net in nets.items():
        num = net.num
        for n_act in (0, 1, 37, num // 100, num):
            ids = torch.from_numpy(rng.permutation(num).astype(np.int32))
            ids = ids.to(device)
            n_ids = torch.tensor([n_act], dtype=torch.int32, device=device)
            got = torch.zeros(2, num, dtype=torch.int32, device=device)
            sc.event_count_scatter(ids, n_ids, net.conn_all, net.n_exc, got)
            want = sc.event_count_scatter_twin(
                ids, n_ids, net.conn_all, net.n_exc, torch.zeros_like(got))
            torch.cuda.synchronize()
            worst = max(worst, float((got - want).abs().max()))
            check(torch.equal(got, want), (label, n_act))
            # the float form on the same events with 0/1 values
            sel = ids[:n_act].long()
            targets = net.conn_all[sel].reshape(-1)
            is_exc = (sel < net.n_exc).to(torch.float32)
            vals = torch.stack([is_exc, 1 - is_exc])
            vals = vals[:, :, None].expand(2, n_act, net.conn_all.shape[1])
            vals = vals.reshape(2, -1).contiguous()
            out = torch.zeros(2, num, device=device)
            sc.event_scatter_float(targets.contiguous(), vals, out)
            ref = sc.event_scatter_float_twin(targets, vals,
                                              torch.zeros_like(out))
            torch.cuda.synchronize()
            check(torch.equal(out, ref), (label, n_act, 'float'))
            check(torch.equal(out, want.to(torch.float32)), (label, n_act))
            print(f'{label} n_act={n_act}: counts equal, float form equal')
    return worst


# (label, EINet scale, COBA) of phase 5's runs through K21
SLICE_NETS = (('4k', 1.0, True), ('4k', 1.0, False), ('40k', 10.0, True),
              ('400k', 100.0, True))
EI_STEPS = 2000


def state_fields(state):
    """The five arrays of an ``EINetState``, in ``einet_pallas_sim``'s order."""
    return (state.neurons.v, state.neurons.t_last, state.g_e, state.g_i,
            state.spike_count)


def k1k2_ops():
    """``_simulate``'s keywords for the loop of K1 and K2, two launches a
    step: the route K21 replaced, run explicitly."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
    return dict(step_op=nw.einet_step, scatter_op=sc.event_count_scatter)


def twin_ops():
    """``_simulate``'s keywords for the twin loop on the card."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
    return dict(step_op=nw.einet_step_twin,
                scatter_op=sc.event_count_scatter_twin)


def check_equal_fields(got, want, what):
    """All five outputs of two runs bitwise equal."""
    for name, x, y in zip(('v', 't_last', 'g_e', 'g_i', 'spike_count'), got,
                          want):
        check(x.dtype == y.dtype and torch.equal(x, y), (what, name))


def check_slice(device):
    phase(f'5 the slice: einet_pallas_sim at 4k (COBA, CUBA), 40k and 400k '
          f'(COBA), {EI_STEPS} steps through K21, one launch each: all five '
          f'outputs bitwise the twin loop and the K1 + K2 loop; above K21\'s '
          f'capacity EINet.run on K1 + K2, bitwise the twin loop')
    import brainevent_torch as bt
    from brainevent_torch.models import networks as nw
    n_steps = EI_STEPS
    launches = None
    for label, scale, coba in SLICE_NETS:
        net = bt.EINet(scale=scale, coba=coba, device=device)
        state = net.init_state()
        bt.reset_launch_counts()
        t0 = time.perf_counter()
        out = bt.einet_pallas_sim(net, state, n_steps)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        counts = bt.launch_counts()
        if label == '4k' and coba:
            launches = counts
        check(counts['einet_sim'] == 1 and counts['einet_step'] == 0
              and counts['event_count_scatter'] == 0, (label, counts))
        t0 = time.perf_counter()
        ref = net._simulate(state, net.times(n_steps), 20.0, **twin_ops())
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t0
        k12 = net._simulate(state, net.times(n_steps), 20.0, **k1k2_ops())
        v, t_last, g_e, g_i, spike_count = out
        for x in (v, t_last, g_e, g_i):
            check(x.shape == (net.num,) and bool(torch.isfinite(x).all()),
                  'finite (num,) state')
        check(spike_count.dtype == torch.int32, spike_count.dtype)
        check_equal_fields(out, state_fields(ref), (label, coba, 'twin'))
        check_equal_fields(out, state_fields(k12), (label, coba, 'K1 + K2'))
        rate = float(spike_count.float().mean()) / (n_steps * net.dt * 1e-3)
        check(5.0 < rate < 200.0, rate)
        print(f'{"COBA" if coba else "CUBA"} {label}: all five outputs '
              f'bitwise the twin loop and the K1 + K2 loop '
              f'({int(spike_count.sum())} spikes), rate {rate!r} Hz, '
              f'launches {counts["einet_sim"]} K21, {counts["einet_step"]} '
              f'K1, {counts["event_count_scatter"]} K2; K21 '
              f'{t_kernel / n_steps * 1e6!r} us/step, twin loop '
              f'{t_twin / n_steps * 1e6!r} us/step (host clock, the first '
              f'call at each size)')
    # the route by size: above what K21's NPT = 8 instance holds
    cap = nw.einet_sim_capacity(device)
    net = bt.EINet(scale=float(cap // 4000 + 1), device=device)
    check(net.num > cap, (net.num, cap))
    state = net.init_state()
    bt.reset_launch_counts()
    out = state_fields(net.run(n_steps, state=state))
    torch.cuda.synchronize()
    big_counts = bt.launch_counts()
    check(big_counts['einet_sim'] == 0
          and big_counts['einet_step'] == n_steps + 1
          and big_counts['event_count_scatter'] == n_steps, big_counts)
    ref = net._simulate(state, net.times(n_steps), 20.0, **twin_ops())
    check_equal_fields(out, state_fields(ref), ('above capacity', net.num))
    print(f'COBA {net.num} (above K21\'s capacity of {cap} neurons): '
          f'EINet.run on {big_counts["einet_step"]} K1 + '
          f'{big_counts["event_count_scatter"]} K2 launches, no K21, bitwise '
          f'the twin loop ({int(out[4].sum())} spikes)')
    return launches, big_counts


def time_run(net, n_steps, warm, strategy='auto'):
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


# (label, steps timed, warm-up steps) of phase 6's EI runs
EI_TIMES = (('4k', 100_000, 1000), ('400k', 5000, 200))
GRAPH_STEPS = 2000          # the K1 + K2 loop captured in one CUDA graph


def time_routes(net, n_steps, warm):
    """COBA us/step (host clock) through K21 (``einet_pallas_sim``) and
    through the K1 + K2 loop from the state *warm* K21 steps in, in turns
    K21, K1 + K2, K1 + K2, K21; each run checked bitwise against the
    other route's. Returns ``({route: [us, us]}, rate, K21's final)``."""
    import brainevent_torch as bt
    state = net.run(warm)
    torch.cuda.synchronize()
    times = net.times(warm + n_steps)[warm:]
    runs = {'K21': [], 'K1 + K2': []}
    outs = {}
    for route in ('K21', 'K1 + K2', 'K1 + K2', 'K21'):
        kw = {} if route == 'K21' else k1k2_ops()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net._simulate(state, times, 20.0, **kw)
        torch.cuda.synchronize()
        runs[route].append((time.perf_counter() - t0) / n_steps * 1e6)
        outs[route] = state_fields(out)
    check_equal_fields(outs['K21'], outs['K1 + K2'], ('timed runs', net.num))
    final = outs['K21']
    rate = float(final[4].float().mean() - state.spike_count.float().mean()
                 ) / (n_steps * net.dt * 1e-3)
    return runs, rate, bt.EINetState(bt.LIFRefState(*final[:2]), *final[2:])


def graph_us_per_step(net, state, replays):
    """The K1 + K2 loop of :data:`GRAPH_STEPS` steps from *state* captured
    in one ``torch.cuda.CUDAGraph``: us per step on replay (host clock
    over *replays* replays), a yardstick of the two-kernel form without a
    launch path, not a route of the package. The replay's outputs are
    checked bitwise against an eager run of the same loop."""
    times = net.times(GRAPH_STEPS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = state_fields(net._simulate(state, times, 20.0, **k1k2_ops()))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = net._simulate(state, times, 20.0, **k1k2_ops())
    graph.replay()
    torch.cuda.synchronize()
    check_equal_fields(state_fields(captured), eager, 'CUDA graph replay')
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
    beforehand), with the instance, grid and table of *kw* (default: the
    package's choice, over conn)."""
    from brainevent_torch.models import networks as nw
    bufs = [x.clone() for x in state_fields(state)]
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
    return a.elapsed_time(b), blocks


# the clusters of K21's bare cluster barrier loop
CLUSTER_FLOORS = (2, 4, 8, 16)


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
    """Phase 6's EI timing at :data:`EI_TIMES`: K21 beside the K1 + K2
    loop (in turns), its CUDA-graph capture, K21's device time by grid
    instance (every NPT whose grid fits) and its bare barrier loop; where
    the package runs K21's cluster instance, that instance's device time
    and the bare cluster barrier loop at :data:`CLUSTER_FLOORS`."""
    from brainevent_torch.models import networks as nw
    res, finals = {}, {}
    for label, n_steps, warm in EI_TIMES:
        net = nets[label]
        runs, rate, final = time_routes(net, n_steps, warm)
        finals[label] = (warm + n_steps, state_fields(final))
        graph_us = graph_us_per_step(
            net, final, max(1, round(n_steps / GRAPH_STEPS)))
        npt, blocks = nw.einet_sim_grid(net.num, device)
        by_npt = {}
        for k in nw.SIM_NPT:
            need = -(-net.num // (k * nw.SIM_BLOCK))
            if need <= nw.einet_sim_max_blocks(device, k):
                ms, _ = sim_device_ms(net, final, n_steps, warm + n_steps,
                                      npt=k)
                by_npt[k] = ms / n_steps * 1e3
        bar_ms, _ = barrier_ms(net, n_steps, device)
        sim_ms, _ = sim_device_ms(net, final, EI_STEPS, warm + n_steps)
        n_conn = net.conn_all.shape[1]
        cluster = nw.einet_sim_cluster(net.num, n_conn, device)
        floors, cluster_us = {}, None
        if cluster is not None:
            ms, _ = sim_device_ms(net, final, n_steps, warm + n_steps)
            cluster_us = ms / n_steps * 1e3
            _, share, k = cluster
            for c in CLUSTER_FLOORS:
                floors[c] = cluster_barrier_ms(
                    n_steps, c, share, k, n_conn, device) / n_steps * 1e3
            print(f'COBA {label}: K21\'s cluster instance (blocks, share, '
                  f'NPT) {cluster} {cluster_us!r} device us/step; the bare '
                  f'cluster barrier loop, us/step by blocks {floors!r}')
        res[label] = dict(us=runs, graph_us=graph_us, npt=npt, blocks=blocks,
                          device_us_by_npt=by_npt,
                          barrier_us=bar_ms / n_steps * 1e3,
                          cluster=cluster, cluster_us=cluster_us,
                          cluster_barrier_us=floors,
                          sim_ms=sim_ms, steps=n_steps, final=final,
                          start=warm + n_steps)
        print(f'COBA {label} over {n_steps} steps after {warm} (rate '
              f'{rate!r} Hz), us/step on the host clock: K21 {runs["K21"]!r}, '
              f'the K1 + K2 loop {runs["K1 + K2"]!r} (in turns), the K1 + K2 '
              f'loop of {GRAPH_STEPS} steps as one CUDA graph {graph_us!r} '
              f'(replayed); K21\'s grid instance device us/step by NPT '
              f'{by_npt!r} (the fewest: NPT {npt}, {blocks} blocks of '
              f'{nw.SIM_BLOCK}); its bare barrier loop '
              f'{bar_ms / n_steps * 1e3!r} us/step; one K21 launch of '
              f'{EI_STEPS} steps {sim_ms!r} ms (device)')
    return res, finals


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


# The H100 SXM's published peaks (NVIDIA's H100 datasheet): HBM at
# 3.35 TB/s and float32 outside the tensor cores at 67 TFLOP/s, the rate
# also used here for the kernels' 32-bit integer work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def bound(n_bytes, n_ops):
    """The least time the card could take for work that moves *n_bytes*
    and does *n_ops*: ``(ms, 'bytes' or 'operations')``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def count_scatter_bytes(n_events, n_conn):
    """The bytes an int32 hit-count scatter (K2, K20) must move for
    *n_events* spikes of *n_conn* targets each: the ids and the spiking
    rows read once, and a read and a write of each counter hit. The
    caller zeroes the counts in a launch of its own, so the rest of the
    buffer is not the kernel's traffic."""
    return 4 * n_events * (1 + n_conn) + 8 * n_events * n_conn


def time_k21(net, state, ei, device):
    """K21's line at the main path's shape: one launch of EI_STEPS steps
    of COBA 4k from *state* (the timed run's end; device ms from phase
    6), its twin's ms on the same inputs (bitwise equal), and the work
    this run needs: the state read and written once, the step times, the
    rows of the neurons that spiked; 20 operations a neuron a step and
    one add a hit."""
    from brainevent_torch.models import networks as nw
    start = ei['start']
    _, got = sim_device_ms(net, state, EI_STEPS, start)
    want = [x.clone() for x in state_fields(state)]
    times = torch.tensor(net.times(start + EI_STEPS)[start:],
                         dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nw.einet_sim_twin(*want, net.conn_all, times, net.step_params(),
                      net.n_exc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check_equal_fields(got, want, 'K21 line vs twin')
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    new = got[4] - state.spike_count
    n_conn = net.conn_all.shape[1]
    n_bytes = (40 * net.num + 4 * EI_STEPS
               + 4 * n_conn * int((new > 0).sum()))
    n_ops = 20 * net.num * EI_STEPS + n_conn * int(new.sum())
    print(f'K21 one launch of {EI_STEPS} steps at COBA 4k: device '
          f'{ei["sim_ms"]!r} ms, twin {plain_ms!r} ms, bitwise; '
          f'{int(new.sum())} spikes, bound {bound(n_bytes, n_ops)!r}')
    return dict(ms=ei['sim_ms'], plain_ms=plain_ms, bytes=n_bytes,
                ops=n_ops, err=err)


def time_kernels(nets, finals, device):
    """K1 and K2 against their twins at the main path's shapes: the state
    each timed run ended in, and the spike list of one more step from it."""
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
        res = dict(
            k1_ms=device_ms(lambda: k1(nw.einet_step), reps),
            k1_host_ms=host_ms(lambda: k1(nw.einet_step), reps),
            k1_twin_ms=host_ms(lambda: k1(nw.einet_step_twin), reps_twin))
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
        # the library yardstick of K2: one index_add_ of ones into the two
        # channels (E hits at [0, num), I hits at [num, 2 num)) over the
        # same events' targets, gathered beforehand
        src = ids[:n_events].long()
        tgt = (net.conn_all[src].long() + num * (src >= net.n_exc).long()[
            :, None]).reshape(-1)
        ones = torch.ones(tgt.numel(), dtype=torch.int32, device=device)
        flat = torch.zeros(2 * num, dtype=torch.int32, device=device)
        n_conn = net.conn_all.shape[1]
        res.update(
            k2_library_ms=device_ms(lambda: flat.index_add_(0, tgt, ones),
                                    reps),
            k1_bytes=56 * num, k2_bytes=count_scatter_bytes(n_events, n_conn),
            k2_events=n_events)
        out[label] = res
        print(f'{label} ({num} neurons), ms per call: K1 device '
              f'{res["k1_ms"]!r}, host-paced {res["k1_host_ms"]!r}, twin '
              f'{res["k1_twin_ms"]!r}; K2 ({n_events} spikes) device '
              f'{res["k2_ms"]!r}, host-paced {res["k2_host_ms"]!r}, twin '
              f'{res["k2_twin_ms"]!r}')
    return out


# -- the training slice and binary_fcnmv (K3-K6) ---------------------------------

BIG = dict(n_in=100, n_hidden=100_000, n_out=10, n_conn=100)
SMALL = dict(n_in=12, n_hidden=128, n_out=4, n_conn=8)


def check_plans(model, device):
    """K3 and K4 on both plans of the full-width model: y within
    1e-5 * sum|w x| of the twin's per row, dw bitwise (0 at padding), and
    two launches on the same inputs bitwise equal. K3 runs over the plan's
    row index with row-order weights (``sort_rows``, and
    ``gather_matvec``'s reorder of plan-order weights): bitwise K4's y,
    which K4 computes from the same view, passed or made by the call."""
    phase('7 K3 plan_gather_mv / K4 plan_matvec_dw vs twin at 100k x 100 '
          '(tolerance: |dy| <= 1e-5 * sum|w x| per row; dw bitwise; K3 '
          'bitwise K4\'s y)')
    from brainevent_torch.ops import mxu_gather as mg
    gen = torch.Generator(device='cpu').manual_seed(7)
    n = model.n_hidden
    w_rec = model.init_params().w_rec
    worst = {'plan_gather_mv': 0.0, 'plan_matvec_dw': 0.0}
    for label, plan in (('outgoing', model._plan), ('incoming', model._plan_T)):
        w_sorted, w_row = plan.sort_data(w_rec), plan.sort_rows(w_rec)
        check(torch.equal(w_row, plan.rows_of(w_sorted)), ('sort_rows', label))
        s = (torch.rand(n, generator=gen) < 0.18).float().to(device)
        for xkind in ('normal', 'spikes 18%'):
            x = (torch.randn(n, generator=gen).to(device)
                 if xkind == 'normal'
                 else (torch.rand(n, generator=gen) < 0.18).float().to(device))
            bound = 1e-5 * mg.gather_matvec_xla(plan, w_sorted.abs(), x.abs())
            y = mg.plan_gather_mv(plan, w_row, x)
            y_public = mg.gather_matvec(plan, w_sorted, x)
            y_twin = mg.gather_matvec_xla(plan, w_sorted, x)
            y_rows = mg.plan_gather_mv.twin(plan, w_row, x)
            y4, dw = mg.plan_matvec_dw(plan, w_sorted, s, x)
            y4_view, dw_view = mg.plan_matvec_dw(plan, w_sorted, s, x,
                                                 w_row=w_row)
            y4_twin, dw_twin = mg.matvec_dw_xla(plan, w_sorted, s, x)
            y_again = mg.plan_gather_mv(plan, w_row, x)
            y4_again, dw_again = mg.plan_matvec_dw(plan, w_sorted, s, x,
                                                   w_row=w_row)
            torch.cuda.synchronize()
            check(bool(((y - y_twin).abs() <= bound).all()), ('K3', label))
            check(bool(((y - y_rows).abs() <= bound).all()),
                  ('K3 row twin', label))
            check(torch.equal(y, y4) and torch.equal(y, y_public),
                  ('K3 bitwise K4 and gather_matvec', label))
            check(bool(((y4 - y4_twin).abs() <= bound).all()), ('K4', label))
            check(torch.equal(dw, dw_twin), ('K4 dw', label))
            check(torch.equal(y4_view, y4) and torch.equal(dw_view, dw),
                  ('K4 with the row view bitwise without it', label))
            check(bool((dw[plan.perm < 0] == 0).all()), ('K4 dw padding',
                                                         label))
            check(torch.equal(y, y_again), ('K3 repeat', label))
            check(torch.equal(y4, y4_again) and torch.equal(dw, dw_again),
                  ('K4 repeat', label))
            e3 = float((y - y_twin).abs().max())
            e4 = float((y4 - y4_twin).abs().max())
            worst['plan_gather_mv'] = max(worst['plan_gather_mv'], e3)
            worst['plan_matvec_dw'] = max(worst['plan_matvec_dw'], e4)
            print(f'{label} plan ({plan.nse} slots, {plan.n_chunks} chunks), '
                  f'x {xkind}: K3 max|dy| {e3!r}, K4 max|dy| {e4!r}, dw '
                  f'equal (0 at padding), K3 bitwise K4\'s y, K4 with the '
                  f'row view bitwise without it, repeats bitwise equal')
    return worst


def fcn_inputs(n, k, rate, homo, spikes, gen, device):
    idx = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32)
    w = (torch.tensor([0.5]) if homo
         else torch.randn(n, k, generator=gen))
    on = torch.rand(n, generator=gen) < rate
    s = on if spikes == 'bool' else torch.where(
        on, 1.0, -0.5 * torch.rand(n, generator=gen))
    return [t.to(device) for t in (w, idx, s)]


def check_fcn(device):
    """K5 and K6 at 10M synapses against their twins."""
    phase('8 K5 fcn_event_scatter / K6 fcn_event_gather vs twin at 100k x '
          '100 (tolerance: homogeneous exact; K5 hetero 1e-5 * sum|w| per '
          'target; K6 hetero 1e-6 * sum|w| per row)')
    from brainevent_torch.fcn import binary as fb
    gen = torch.Generator(device='cpu').manual_seed(8)
    n, k = 100_000, 100
    worst = {'fcn_event_scatter': 0.0, 'fcn_event_gather': 0.0}
    for rate in (0.0, 0.001, 0.01, 1.0):
        for homo in (True, False):
            for spikes in ('bool', 'float'):
                w, idx, s = fcn_inputs(n, k, rate, homo, spikes, gen, device)
                for op, tol in ((fb.fcn_event_scatter, 1e-5),
                                (fb.fcn_event_gather, 1e-6)):
                    got = op(w, idx, s, n)
                    want = op.twin(w, idx, s, n)
                    bound = op.twin(w.abs(), idx, s, n)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    worst[op.name] = max(worst[op.name], err)
                    if homo:
                        check(torch.equal(got, want), (op.name, rate, spikes))
                    else:
                        check(bool(((got - want).abs() <= tol * bound).all()),
                              (op.name, rate, spikes, err))
                print(f'rate {rate}, {"homo" if homo else "hetero"}, '
                      f'{spikes} spikes: K5 and K6 within tolerance')
    return worst


def drive_fcnmv(device):
    """The 10M-synapse event product through ``binary_fcnmv``, as its users
    call it: homogeneous weight 0.5, bool spikes at 0.1% and 1%, both
    directions."""
    import brainevent_torch as bt
    gen = torch.Generator(device='cpu').manual_seed(12)
    n, k = 100_000, 100
    runs = []
    for rate in (0.001, 0.01):
        runs.append((rate, fcn_inputs(n, k, rate, True, 'bool', gen, device)))
    bt.reset_launch_counts()
    for rate, (w, idx, s) in runs:
        for transpose in (True, False):
            y = bt.binary_fcnmv(w, idx, s, shape=(n, n), transpose=transpose)
            check(y.shape == (n,) and bool(torch.isfinite(y).all()), rate)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    check(counts['fcn_event_scatter'] == 2 and counts['fcn_event_gather'] == 2,
          counts)
    print(f'binary_fcnmv at 10M synapses, 0.1% and 1%, both directions: '
          f'launches {counts["fcn_event_scatter"]} K5 + '
          f'{counts["fcn_event_gather"]} K6')
    return runs, counts


def twin_model(model):
    """The same network with the recurrent product on the twins."""
    from brainevent_torch.models import training as tr
    twin = copy.copy(model)
    twin._ops = tr._RecOps(*(op.twin for op in tr._KERNEL_OPS))
    return twin


def loss_and_grads(model, params, x, label):
    import brainevent_torch as bt
    leaves = [p.clone().requires_grad_(True) for p in params]
    loss = bt.snn_loss(model, bt.SNNParams(*leaves), x, label)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def check_training_small(device):
    phase('9 the training slice, small: 12-128-4, n_conn 8, T 20, kernels '
          'vs twin route on the card (spikes equal, loss rtol 1e-5, grads '
          'rtol 1e-4 atol 1e-6)')
    import brainevent_torch as bt
    x = torch.from_numpy(np.random.default_rng(9).random((20, 12)).astype(
        F32)).to(device)
    for forward in ('plan', 'event'):
        model = bt.SurrogateSNN(**SMALL, seed=3, forward=forward,
                                device=device)
        twin = twin_model(model)
        p = model.init_params()
        spikes = model._spikes(p, x)
        check(torch.equal(spikes, twin._spikes(p, x)), (forward, 'spikes'))
        (la, ga), (lb, gb) = (loss_and_grads(m, p, x, 1)
                              for m in (model, twin))
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
        print(f'forward={forward}: rate {float(spikes.mean())!r}, spike '
              f'trains equal, loss {float(la)!r} after 10 train steps, '
              f'loss, grads and params within tolerance of the twin route')


def profile_step(fn):
    """Device busy time of one call of *fn* (``torch.profiler``: the sum of
    kernel times), the call's wall time under the profiler, and the eight
    largest kernels by total time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return busy_us, wall_us, [(e.key[:60], e.count, e.self_device_time_total)
                              for e in top]


def train_step_times(model, p, x):
    """Five train steps of *model* from *p* on the host clock (their
    median), then one profiled step: its kernel time, wall time, idle
    share and largest kernels."""
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
    busy_us, wall_us, top = profile_step(
        lambda: bt.train_step(model, q, x, 3, lr=1e-3))
    return dict(ms=sorted(times)[2], times_ms=times, kernel_us=busy_us,
                wall_us=wall_us, idle=1 - busy_us / wall_us, top=top)


def check_training_full(model, device):
    phase('10 the training slice at full width: 100k hidden x 100 conn '
          '(10M synapses), T 50, label 3, lr 1e-3')
    import brainevent_torch as bt
    gen = torch.Generator(device='cpu').manual_seed(10)
    x = torch.rand(50, 100, generator=gen).to(device)
    p = model.init_params()
    bt.reset_launch_counts()
    p1, loss = bt.train_step(model, p, x, 3, lr=1e-3)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    check({k: v for k, v in counts.items() if v} == {
        'plan_gather_mv': 50, 'plan_matvec_dw': 50}, counts)
    check(bool(torch.isfinite(loss)), loss)
    print(f'warm-up train step: loss {float(loss)!r}, launches '
          f'{counts["plan_gather_mv"]} K3 + {counts["plan_matvec_dw"]} K4')
    t = train_step_times(model, p1, x)
    ms = t['ms']
    la, ga = loss_and_grads(model, p, x, 3)
    lb, gb = loss_and_grads(model, p, x, 3)
    torch.cuda.synchronize()
    check(torch.equal(la, lb) and all(map(torch.equal, ga, gb)),
          'bitwise repeat')
    g_rec = ga[1]
    check(bool(torch.isfinite(g_rec).all()) and bool((g_rec != 0).any()),
          'w_rec gradient finite and non-zero')
    print(f'train step: {ms!r} ms (median of 5: {t["times_ms"]!r}), '
          f'{ms / 50 * 1e3!r} us per simulated step (host clock); loss and '
          f'grads bitwise equal over two runs, |grad w_rec| max '
          f'{float(g_rec.abs().max())!r}')
    print(f'profiled train step: kernels {t["kernel_us"]!r} us of '
          f'{t["wall_us"]!r} us wall under the profiler (device idle '
          f'{t["idle"]!r} there; {1 - t["kernel_us"] / (ms * 1e3)!r} of the '
          f'unprofiled median); largest kernels (name, launches, us): '
          f'{t["top"]!r}')
    event = copy.copy(model)
    event.forward = 'event'
    bt.reset_launch_counts()
    _, loss = bt.train_step(event, p, x, 3, lr=1e-3)
    torch.cuda.synchronize()
    event_counts = bt.launch_counts()
    check(event_counts['fcn_event_scatter'] == 50
          and event_counts['plan_matvec_dw'] == 50
          and event_counts['plan_gather_mv'] == 0, event_counts)
    check(bool(torch.isfinite(loss)), loss)
    print(f"forward='event' train step: loss {float(loss)!r}, launches "
          f"{event_counts['fcn_event_scatter']} K5 + "
          f"{event_counts['plan_matvec_dw']} K4")
    return counts, event_counts, ms


def check_learning(device):
    phase('11 learning on the card: 40-2000-4, n_conn 32, 4 class-templated '
          'inputs (50, 40), 30 epochs at lr 0.5')
    import brainevent_torch as bt
    model = bt.SurrogateSNN(n_in=40, n_hidden=2000, n_out=4, n_conn=32,
                            seed=1, device=device)
    rng = np.random.default_rng(0)
    xn = 0.2 * rng.random((4, 50, 40)).astype(F32)
    for c in range(4):
        xn[c, :, 10 * c:10 * c + 10] += 1.0
    xs = torch.from_numpy(xn).to(device)

    def mean_loss(p):
        with torch.no_grad():
            return float(sum(bt.snn_loss(model, p, xs[c], c)
                             for c in range(4)) / 4)

    p = model.init_params()
    l0 = mean_loss(p)
    t0 = time.perf_counter()
    for _ in range(30):
        for c in range(4):
            p, _ = bt.train_step(model, p, xs[c], c, lr=0.5)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    l1 = mean_loss(p)
    check(l1 < l0, (l0, l1))
    print(f'loss {l0!r} -> {l1!r} after 30 epochs ({seconds!r} s); the JAX '
          f'script\'s target < 0.2: {"met" if l1 < 0.2 else "not met"}')


def time_new_kernels(model, runs, device):
    phase('12 timing at full width: device ms per launch (launches queued '
          'back to back) and the twin\'s ms per call')
    from brainevent_torch.fcn import binary as fb
    from brainevent_torch.ops import mxu_gather as mg
    gen = torch.Generator(device='cpu').manual_seed(11)
    n = model.n_hidden
    p = model.init_params()
    spk = (torch.rand(n, generator=gen) < 0.18).float().to(device)
    ct = torch.randn(n, generator=gen).to(device)
    # K3 reads the incoming plan's row-order weights and K4 the outgoing
    # plan's, each made once per train step (SurrogateSNN._fwd_weights,
    # SurrogateSNN._spikes); those reorders are timed apart
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
        print(f'{name} (18% spikes): device {out[name]["ms"]!r} ms, twin '
              f'{out[name]["plain_ms"]!r} ms')
    no_view_ms = device_ms(lambda: mg.plan_matvec_dw_op(
        model._plan, w_sorted, spk, ct), 50)
    print(f'plan_matvec_dw without the row view (the call makes it): '
          f'{no_view_ms!r} ms')
    for label, plan in (('incoming (K3)', model._plan_T),
                        ('outgoing (K4)', model._plan)):
        reorder_ms = device_ms(lambda: plan.sort_rows(p.w_rec), 50)
        print(f'the {label} plan\'s row-order weight view (sort_rows, one '
              f'{plan.nse}-entry gather, once per train step): '
              f'{reorder_ms!r} ms')
    for rate, (w, idx, s) in runs:
        for op in (fb.fcn_event_scatter, fb.fcn_event_gather):
            args = (w, idx, s, n)
            r = dict(ms=device_ms(lambda: op(*args), 100),
                     plain_ms=host_ms(lambda: op.twin(*args), 5))
            out[(op.name, rate)] = r
            print(f'{op.name} (rate {rate}, homogeneous, bool): device '
                  f'{r["ms"]!r} ms, twin {r["plain_ms"]!r} ms')
    for name in ('fcn_event_scatter', 'fcn_event_gather'):
        out[name] = out[(name, 0.01)]
    # the library yardsticks (cuSPARSE through torch.sparse.mm, or one
    # index_add_) on the same inputs, and the bytes each kernel must move
    nse, k = model._plan.nse, model.n_conn
    src = torch.arange(n, device=device).repeat_interleave(k)
    tgt = model.rec_indices.reshape(-1).long()
    rec = torch.sparse_coo_tensor(torch.stack([tgt, src]),
                                  p.w_rec.reshape(-1), (n, n)).coalesce()
    rec_csr = rec.to_sparse_csr()
    x = spk[:, None]
    out['plan_gather_mv'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(rec_csr, x), 50),
        bytes=8 * nse + 8 * n, ops=2 * nse)
    out['plan_matvec_dw'].update(bytes=12 * nse + 12 * n, ops=3 * nse)
    w, idx, s = dict(runs)[0.01]
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
        selected_index_add_ms=device_ms(
            lambda: y.index_add_(0, active, vals), 100),
        bytes=n + 4 * active.numel() + 4 * n, ops=active.numel())
    out['fcn_event_gather'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(ell, sf), 100),
        bytes=4 * n * k + 5 * n, ops=n * k)
    for name in ('plan_gather_mv', 'fcn_event_scatter', 'fcn_event_gather'):
        print(f'{name}: library call {out[name]["library_ms"]!r} ms')
    print(f'fcn_event_scatter: index_add_ after selection (the active rows\' '
          f'targets gathered outside the timed call; not the same function) '
          f'{out["fcn_event_scatter"]["selected_index_add_ms"]!r} ms')
    return out


# -- the CSR slice (K7-K10) ------------------------------------------------------

# the reference grid's largest CSR event-SpMV shape, (10k, 10k, 10%), and
# the csrmm cell (10k, 10k, 1%, B = 256)
CSR_N, CSR_DENSITY = 10_000, 0.1
MM_N, MM_DENSITY, MM_B = 10_000, 0.01, 256
SLICE_STEPS, SLICE_RATE, SLICE_B = 100, 0.01, 16


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


@contextlib.contextmanager
def twins_on_card(ops):
    """Run *ops* through their twins on CUDA tensors for the length of the
    block (the reference run of a phase; twin calls are not launches)."""
    saved = {op: op.cuda for op in ops}
    for op in ops:
        op.cuda = lambda op_, *a, **k: op_.twin(*a, **k)
    try:
        yield
    finally:
        for op, fn in saved.items():
            op.cuda = fn


def within(got, want, bound, what):
    """Check ``|got - want| <= 1e-5 * bound`` elementwise; the max error."""
    torch.cuda.synchronize()
    check(bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all()), what)
    return float((got - want).abs().max()) if got.numel() else 0.0


def event_operand(n, rate, kind, gen, device, batch=None):
    shape = (n,) if batch is None else (n, batch)
    on = torch.rand(shape, generator=gen, device=device) < rate
    if kind == 'bool':
        return on
    if kind == 'float':
        return torch.where(on, 1.0, -0.5 * torch.rand(
            shape, generator=gen, device=device))
    return torch.randn(shape, generator=gen, device=device)


def check_csr_event(W, device):
    phase(f'13 K7 csr_gather_mv / K8 csr_scatter_mv vs twin at {CSR_N} x '
          f'{CSR_N}, {CSR_DENSITY:.0%} ({W.nse} entries) (tolerance: '
          f'homogeneous binary exact; others |d| <= 1e-5 * sum|w op(x)|; '
          f'K7 repeats bitwise)')
    from brainevent_torch.csr import pallas_kernels as pk
    gen = torch.Generator(device=device).manual_seed(13)
    n, ptr, idx = CSR_N, W.indptr, W.indices
    homo_w = torch.tensor([0.5], device=device)
    perm = torch.randperm(W.nse, generator=gen, device=device).to(torch.int32)
    worst = {'csr_gather_mv': 0.0, 'csr_scatter_mv': 0.0}
    cases = [(rate, kind, homo, None) for rate in (0.0, 0.001, 0.01, 0.1, 1.0)
             for kind in ('bool', 'float') for homo in (True, False)]
    cases += [(0.01, 'bool', False, perm), (0.01, 'float', False, perm),
              (1.0, 'identity', True, None), (1.0, 'identity', False, None),
              (1.0, 'identity', False, perm)]
    for rate, kind, homo, p in cases:
        x = event_operand(n, rate, kind, gen, device)
        w = homo_w if homo else W.data
        binary = kind != 'identity'
        xb = x.abs() if kind == 'identity' else x
        for op, extra in ((pk.csr_gather_mv, ()), (pk.csr_scatter_mv, (n,))):
            got = op(ptr, idx, p, w, x, binary, *extra)
            want = op.twin(ptr, idx, p, w, x, binary, *extra)
            if homo and binary:
                torch.cuda.synchronize()
                check(torch.equal(got, want), (op.name, rate, kind))
                err = 0.0
            else:
                err = within(got, want, op.twin(ptr, idx, p, w.abs(), xb,
                                                binary, *extra),
                             (op.name, rate, kind, homo))
            worst[op.name] = max(worst[op.name], err)
            if op is pk.csr_gather_mv:
                again = op(ptr, idx, p, w, x, binary)
                torch.cuda.synchronize()
                check(torch.equal(got, again), ('K7 repeat', rate, kind))
        print(f'rate {rate}, {kind}, {"homo" if homo else "hetero"}'
              f'{", perm" if p is not None else ""}: K7 and K8 within '
              f'tolerance')
    return worst


def check_pair_gather(W, device):
    phase(f'14 K9 pair_gather vs twin at {W.nse} entries, and STDP on-pre / '
          f'on-post with clip (tolerance: bitwise)')
    import brainevent_torch as bt
    from brainevent_torch.csr._common import event_gate, row_ids_from_indptr
    from brainevent_torch.ops import pair_gather as pg
    gen = torch.Generator(device=device).manual_seed(14)
    n = CSR_N
    rows = row_ids_from_indptr(W.indptr, W.nse)
    s = torch.randn(n, generator=gen, device=device)
    x = torch.randn(n, generator=gen, device=device)
    sentinel = rows.clone()
    sentinel[::7] = -1
    for label, args in (('both', (rows, W.indices, s, x)),
                        ('rows', (rows, None, s, None)),
                        ('cols', (None, W.indices, None, x)),
                        ('sentinels', (sentinel, W.indices, s, x))):
        got = bt.pair_gather_product(*args)
        want = pg.pair_gather_twin(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), ('K9', label))
        print(f'{label}: bitwise equal')
    spk = torch.rand(n, generator=gen, device=device) < 0.01
    trace = torch.rand(n, generator=gen, device=device)
    got = W.update_on_pre(spk, trace, 0.0, 1.0).data
    want = (W.data + pg.pair_gather_twin(rows, W.indices, event_gate(spk),
                                         trace)).clamp(0.0, 1.0)
    torch.cuda.synchronize()
    check(torch.equal(got, want), 'STDP on-pre')
    got = W.update_on_post(trace, spk, 0.0, 1.0).data
    want = (W.data + pg.pair_gather_twin(rows, W.indices, trace,
                                         event_gate(spk))).clamp(0.0, 1.0)
    torch.cuda.synchronize()
    check(torch.equal(got, want), 'STDP on-post')
    print('STDP on-pre and on-post (1% spikes, clip [0, 1]): bitwise equal')
    return 0.0


def check_ordered(got, ptr, idx, perm, w, X, binary, what):
    """K10's output bitwise its stored-order plain sum on the same
    inputs."""
    from brainevent_torch.ops import mxu_gather as mg
    want = mg.csr_gather_mm_ordered(ptr, idx, perm, w, X, binary)
    torch.cuda.synchronize()
    check(torch.equal(got, want), ('K10 vs the stored-order sum', what))


def slice_mm_operands(W, device):
    """The CSR slice's mat-mat inputs (phase 16 at SLICE_B): ``W @ X`` over
    the CSR arrays, ``Z @ W`` over the CSC mirror with its permutation,
    the operand transposed in as the entry transposes it."""
    from brainevent_torch import _misc
    gen = torch.Generator(device=device).manual_seed(151)
    n = W.shape[0]
    X = torch.randn(n, SLICE_B, generator=gen, device=device)
    Zt = torch.randn(SLICE_B, n, generator=gen, device=device).T.contiguous()
    mirror = _misc.csr_to_csc_index(W.indptr, W.indices, shape=W.shape)
    return {'NT': ((W.indptr, W.indices, None), X),
            'T': (mirror, Zt)}


def mm_plan(A, device):
    """The gather plan of the csrmm cell's matrix *A*, built in numpy."""
    from brainevent_torch.ops import mxu_gather as mg
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr.cpu().numpy()))
    return mg.build_mm_plan(rows, A.indices.cpu().numpy(), A.shape).to(device)


def check_csr_mm(W, device):
    phase(f'15 K10 csr_gather_mm vs twin at ({MM_N}, {MM_N}, '
          f'{MM_DENSITY:.0%}, B = {MM_B}), NT and T, float and binary, '
          f'gather_matmat over an mm plan, and the CSR slice\'s W @ X and '
          f'X @ W at ({CSR_N}, {CSR_N}, {CSR_DENSITY:.0%}, B = {SLICE_B}) '
          f'(tolerance: |d| <= 1e-5 * sum|w x|; bitwise the stored-order '
          f'sum; repeats bitwise)')
    import brainevent_torch as bt
    from brainevent_torch import _misc
    from brainevent_torch.ops import mxu_gather as mg
    gen = torch.Generator(device=device).manual_seed(15)
    A = random_csr(MM_N, MM_DENSITY, 150, device)
    shape = A.shape
    worst = 0.0
    mirror = _misc.csr_to_csc_index(A.indptr, A.indices, shape=shape)
    mirror_ms = host_ms(lambda: _misc.csr_to_csc_index(
        A.indptr, A.indices, shape=shape), 5)
    for kind in ('identity', 'bool', 'float'):
        X = event_operand(MM_N, 0.1, kind, gen, device, batch=MM_B)
        binary = kind != 'identity'
        fn = bt.binary_csrmm if binary else bt.csrmm
        Xb = X.abs() if kind == 'identity' else X
        for transpose in (False, True):
            ptr, idx, perm = ((*mirror,) if transpose
                              else (A.indptr, A.indices, None))
            got = fn(A.data, A.indices, A.indptr, X, shape=shape,
                     transpose=transpose)
            want = mg.csr_gather_mm_twin(ptr, idx, perm, A.data, X, binary)
            bound = mg.csr_gather_mm_twin(ptr, idx, perm, A.data, Xb, binary)
            worst = max(worst, within(got, want, bound,
                                      ('K10', kind, transpose)))
            check_ordered(got, ptr, idx, perm, A.data, X, binary,
                          (kind, transpose))
            again = fn(A.data, A.indices, A.indptr, X, shape=shape,
                       transpose=transpose)
            torch.cuda.synchronize()
            check(torch.equal(got, again), ('K10 repeat', kind, transpose))
            print(f'{kind}, {"T" if transpose else "NT"}: within tolerance, '
                  f'bitwise the stored-order sum, repeats bitwise')
    t0 = time.perf_counter()
    plan = mm_plan(A, device)
    plan_s = time.perf_counter() - t0
    w_sorted = plan.sort_data(A.data)
    X = torch.randn(MM_N, MM_B, generator=gen, device=device)
    got = bt.gather_matmat(plan, w_sorted, X)
    worst = max(worst, within(got, mg.gather_matmat_xla(plan, w_sorted, X),
                              mg.gather_matmat_xla(plan, w_sorted, X.abs()),
                              'gather_matmat'))
    check_ordered(got, plan.row_ptr, plan.row_cols, plan.row_slots,
                  w_sorted.reshape(-1), X, False, 'gather_matmat')
    torch.cuda.synchronize()
    check(torch.equal(got, bt.gather_matmat(plan, w_sorted, X)),
          'gather_matmat repeat')
    print(f'gather_matmat over the mm plan ({plan.nse} slots, built in '
          f'{plan_s!r} s in numpy): within tolerance, bitwise the '
          f'stored-order sum, repeats bitwise; the per-call CSC mirror of a '
          f'functional transposed csrmm takes {mirror_ms!r} ms (host clock)')
    for what, ((ptr, idx, perm), X) in slice_mm_operands(W, device).items():
        got = mg.csr_gather_mm(ptr, idx, perm, W.data, X, False)
        worst = max(worst, within(
            got, mg.csr_gather_mm_twin(ptr, idx, perm, W.data, X, False),
            mg.csr_gather_mm_twin(ptr, idx, perm, W.data, X.abs(), False),
            ('K10 slice', what)))
        check_ordered(got, ptr, idx, perm, W.data, X, False, ('slice', what))
        print(f'the slice\'s {what} at B = {SLICE_B} ({W.nse} entries): '
              f'within tolerance, bitwise the stored-order sum')
    return A, plan, w_sorted, worst, mirror_ms


def csr_step_loop(W, n_steps, device):
    """The CSR slice: per step the event products both ways, trace decay,
    STDP with clip, and the mat-mat products both ways; returns the final
    matrix and every step's products."""
    import brainevent_torch as bt
    gen = torch.Generator(device=device).manual_seed(16)
    n = W.shape[0]
    X = torch.randn(n, SLICE_B, generator=gen, device=device)
    Z = torch.randn(SLICE_B, n, generator=gen, device=device)
    pre = torch.zeros(n, device=device)
    post = torch.zeros(n, device=device)
    outs = []
    for _ in range(n_steps):
        spk = torch.rand(n, generator=gen, device=device) < SLICE_RATE
        pspk = torch.rand(n, generator=gen, device=device) < SLICE_RATE
        a = bt.BinaryArray(spk) @ W
        b = W @ bt.BinaryArray(pspk)
        pre = pre * 0.95 + spk
        post = post * 0.95 + pspk
        W = W.update_on_pre(spk, post, 0.0, 1.0)
        W = W.update_on_post(pre, pspk, 0.0, 1.0)
        outs.append((a, b, W @ X, Z @ W))
    return W, outs


CSR_OPS = ('csr_gather_mv', 'csr_scatter_mv', 'pair_gather', 'csr_gather_mm')


def check_csr_slice(W, device):
    phase(f'16 the CSR slice on the card at {W.nse} entries: {SLICE_STEPS} '
          f'steps of event products both ways, trace decay, STDP with clip, '
          f'W @ X and X @ W (B = {SLICE_B}), through the kernels and through '
          f'the twins (W.data bitwise; products within 1e-5 relative)')
    import brainevent_torch as bt
    from brainevent_torch.ops.core import REGISTRY
    ops = [REGISTRY[name] for name in CSR_OPS]
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    W_k, outs_k = csr_step_loop(W, SLICE_STEPS, device)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / SLICE_STEPS * 1e3
    counts = bt.launch_counts()
    want = {'csr_gather_mv': SLICE_STEPS, 'csr_scatter_mv': SLICE_STEPS,
            'pair_gather': 2 * SLICE_STEPS, 'csr_gather_mm': 2 * SLICE_STEPS}
    check({k: counts[k] for k in CSR_OPS} == want, counts)
    t0 = time.perf_counter()
    with twins_on_card(ops):
        W_t, outs_t = csr_step_loop(W, SLICE_STEPS, device)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) / SLICE_STEPS * 1e3
    check(torch.equal(W_k.data, W_t.data), 'final W.data')
    check(bool(torch.isfinite(W_k.data).all()) and W_k.data.shape == (
        W.nse,), 'W.data finite')
    worst = 0.0
    for ok, ot in zip(outs_k, outs_t):
        for a, b in zip(ok, ot):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                  'product shape')
            scale = b.abs().max().clamp(min=1.0)
            worst = max(worst, float((a - b).abs().max() / scale))
    check(worst <= 1e-5, ('products', worst))
    print(f'{SLICE_STEPS} steps: W.data bitwise equal to the twin run, '
          f'products within {worst!r} relative; launches per step: '
          f'{ {k: counts[k] / SLICE_STEPS for k in CSR_OPS} }; '
          f'{step_ms!r} ms/step through the kernels, {twin_ms!r} ms/step '
          f'through the twins (host clock)')
    # a backward through W @ v, with respect to v and W.data
    gen = torch.Generator(device=device).manual_seed(161)
    v = torch.randn(W.shape[1], generator=gen, device=device)
    ct = torch.randn(W.shape[0], generator=gen, device=device)
    grads = []
    for twin in (False, True):
        data = W_k.data.clone().requires_grad_(True)
        Wg = W_k.with_data(data)
        vv = v.clone().requires_grad_(True)
        with twins_on_card(ops if twin else []):
            y = Wg @ vv
            grads.append((y.detach(), *torch.autograd.grad(
                y, (vv, data), ct)))
    (yk, gvk, gwk), (yt, gvt, gwt) = grads
    torch.cuda.synchronize()
    check(torch.equal(gwk, gwt), 'dW bitwise')
    for a, b in ((yk, yt), (gvk, gvt)):
        check(float((a - b).abs().max() / b.abs().max()) <= 1e-5, 'grad')
    # W @ X at the mm cell's width
    X = torch.randn(W.shape[1], MM_B, generator=gen, device=device)
    bt.reset_launch_counts()
    Y = W_k @ X
    check(bt.launch_counts()['csr_gather_mm'] == 1, 'W @ X launch')
    with twins_on_card(ops):
        Yt = W_k @ X
    rel = float((Y - Yt).abs().max() / Yt.abs().max())
    check(Y.shape == (W.shape[0], MM_B) and rel <= 1e-5, ('W @ X', rel))
    print(f'backward through W @ v: dW bitwise, dv within 1e-5 relative; '
          f'W @ X at B = {MM_B}: within {rel!r} relative')
    busy_us, wall_us, top = profile_step(
        lambda: csr_step_loop(W_k, 10, device))
    print(f'10 profiled steps: kernels {busy_us / 10!r} us of '
          f'{wall_us / 10!r} us wall per step under the profiler (device '
          f'idle {1 - busy_us / wall_us!r} there; '
          f'{1 - busy_us / 10 / (step_ms * 1e3)!r} of the unprofiled '
          f'steps); largest kernels (name, launches, us): {top!r}')
    return counts, W_k


def time_k10(W, A, plan, w_sorted, device):
    """K10 at its four shapes, each beside ``torch.sparse.mm`` of the same
    matrix by the same operand (the transposed CSR built outside the timed
    call): the csrmm cell (MM_N, MM_N, MM_DENSITY, MM_B) NT over the CSR
    arrays and over its mm plan's row index, and the CSR slice's ``W @ X``
    (NT) and ``X @ W`` (T, over the CSC mirror with its permutation) at
    (CSR_N, CSR_N, CSR_DENSITY, SLICE_B). Device ms per launch, the
    library call's, the bytes and operations of the bound, and each twin
    (timed by the caller)."""
    from brainevent_torch import _misc
    from brainevent_torch.ops import mxu_gather as mg
    gen = torch.Generator(device=device).manual_seed(171)
    X = torch.randn(MM_N, MM_B, generator=gen, device=device)

    def sparse(ptr, idx, vals, shape):
        return torch.sparse_csr_tensor(ptr.long(), idx.long(), vals, shape)

    def row(ptr, idx, perm, w, X, lib, reps, nse):
        n_rows, (n_x, B) = ptr.shape[0] - 1, X.shape
        args = (ptr, idx, perm, w, X, False)
        return dict(ms=device_ms(lambda: mg.csr_gather_mm(*args), reps),
                    library_ms=device_ms(lambda: torch.sparse.mm(lib, X),
                                         reps),
                    twin=lambda: mg.csr_gather_mm_twin(*args),
                    bytes=4 * (n_rows + 1) + (12 if perm is not None else 8)
                    * nse + 4 * n_x * B + 4 * n_rows * B,
                    ops=2 * nse * B)

    A_csr = sparse(A.indptr, A.indices, A.data, A.shape)
    res = {'csrmm': row(A.indptr, A.indices, None, A.data, X, A_csr, 20,
                        A.nse)}
    flat = w_sorted.reshape(-1).contiguous()
    res['plan'] = row(plan.row_ptr, plan.row_cols, plan.row_slots, flat, X,
                      A_csr, 20, A.nse)
    res['plan']['twin'] = lambda: mg.gather_matmat_xla(plan, w_sorted, X)
    ops = slice_mm_operands(W, device)
    (ptr, idx, _), Xs = ops['NT']
    res['slice NT'] = row(ptr, idx, None, W.data, Xs,
                          sparse(ptr, idx, W.data, W.shape), 20, W.nse)
    (ptr, idx, perm), Zt = ops['T']
    res['slice T'] = row(ptr, idx, perm, W.data, Zt,
                         sparse(ptr, idx, W.data[perm.long()], W.shape), 20,
                         W.nse)
    for name, r in res.items():
        print(f'K10 {name}: device {r["ms"]!r} ms, torch.sparse.mm '
              f'{r["library_ms"]!r} ms, bound {bound(r["bytes"], 0)[0]!r} ms')
    return res


def time_csr_kernels(W, A, plan, w_sorted, device):
    phase('17 CSR timing: device ms per launch (launches queued back to '
          'back) and the twin\'s ms per call')
    from brainevent_torch.csr import pallas_kernels as pk
    from brainevent_torch.csr._common import event_gate, row_ids_from_indptr
    from brainevent_torch.ops import pair_gather as pg
    gen = torch.Generator(device=device).manual_seed(17)
    n = CSR_N
    homo = torch.tensor([0.5], device=device)
    out = {}
    for rate in (0.001, 0.01):
        s = torch.rand(n, generator=gen, device=device) < rate
        for op, extra in ((pk.csr_gather_mv, ()), (pk.csr_scatter_mv, (n,))):
            args = (W.indptr, W.indices, None, homo, s, True, *extra)
            r = dict(ms=device_ms(lambda: op(*args), 100),
                     plain_ms=host_ms(lambda: op.twin(*args), 10))
            out[(op.name, rate)] = r
            print(f'{op.name} (rate {rate}, homogeneous, bool, {W.nse} '
                  f'entries): device {r["ms"]!r} ms, twin '
                  f'{r["plain_ms"]!r} ms')
    rows = row_ids_from_indptr(W.indptr, W.nse)
    gate = event_gate(torch.rand(n, generator=gen, device=device) < 0.01)
    trace = torch.rand(n, generator=gen, device=device)
    args = (rows, W.indices, gate, trace)
    out['pair_gather'] = dict(ms=device_ms(lambda: pg.pair_gather(*args), 100),
                              plain_ms=host_ms(
                                  lambda: pg.pair_gather_twin(*args), 10))
    k10 = time_k10(W, A, plan, w_sorted, device)
    for name, r in k10.items():
        r['plain_ms'] = host_ms(r.pop('twin'), 3)
        print(f'K10 {name}: twin {r["plain_ms"]!r} ms')
    # K10's line is the main path's shape: the slice launches it at
    # B = 16 once each way a step, so the line takes the mean of the two
    # directions; each shape, the csrmm cell's B = 256 among them, apart
    fields = ('ms', 'plain_ms', 'library_ms', 'bytes', 'ops')
    out['csr_gather_mm'] = {f: (k10['slice NT'][f] + k10['slice T'][f]) / 2
                            for f in fields}
    out['csr_gather_mm']['by_shape'] = {
        name: dict({f: r[f] for f in fields[:3]},
                   bound_ms=bound(r['bytes'], r['ops'])[0])
        for name, r in k10.items()}
    print(f'pair_gather: device {out["pair_gather"]["ms"]!r} ms, twin '
          f'{out["pair_gather"]["plain_ms"]!r} ms')
    for name in ('csr_gather_mv', 'csr_scatter_mv'):
        out[name] = out[(name, 0.01)]
    # the library yardsticks on the same inputs, and the bytes moved
    s = s.float()                       # the 1% spikes of the last rate
    rows_w = row_ids_from_indptr(W.indptr, W.nse)
    Wh = torch.sparse_csr_tensor(W.indptr.long(), W.indices.long(),
                                 homo.expand(W.nse).contiguous(), (n, n))
    act = s[rows_w] != 0
    tgt, vals = W.indices[act].long(), homo.expand(int(act.sum()))
    y = torch.zeros(n, device=device)
    sf = s[:, None]
    # K8's function, y = W^T g(s), as one call: the transposed matrix by
    # the float spikes
    Wt = torch.sparse_coo_tensor(
        torch.stack([W.indices.long(), rows_w.long()]), homo.expand(W.nse),
        (n, n)).coalesce().to_sparse_csr()
    out['csr_gather_mv'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(Wh, sf), 100),
        bytes=4 * (n + 1) + 4 * W.nse + 5 * n, ops=W.nse)
    out['csr_scatter_mv'].update(
        library_ms=device_ms(lambda: torch.sparse.mm(Wt, sf), 100),
        selected_index_add_ms=device_ms(lambda: y.index_add_(0, tgt, vals),
                                        100),
        bytes=5 * n + 4 * tgt.numel(), ops=tgt.numel())
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
    for name in ('csr_gather_mv', 'csr_scatter_mv', 'pair_gather'):
        print(f'{name}: library call {out[name]["library_ms"]!r} ms')
    print(f'csr_scatter_mv: index_add_ after selection (the active rows\' '
          f'targets gathered outside the timed call; not the same function) '
          f'{out["csr_scatter_mv"]["selected_index_add_ms"]!r} ms')
    return out


# -- the JITC slice (K11-K14) ----------------------------------------------------

# BENCH_PRIMS_r05.json's JITC rows: (5120, 5120) at 1%
JITC_N, JITC_PROB, JITC_SEED = 5120, 0.01, 2024
JITC_LAWS = {'scalar': (0, 0.5, 0.0), 'normal': (1, 0.6, 0.06),
             'uniform': (2, 0.48, 0.24)}        # law code, a, b
JITC_STEPS, JITC_SCALAR_STEPS, JITC_SAMPLES = 2000, 1000, 20
JITC_SCALES = {'80k': 20.0, '4k': 1.0}          # JITCNet(scale=...)
JITC_OPS = ('jitc_walk_setup', 'jitc_walk_mv', 'jitc_walk_mm',
            'jitc_walk_mm4', 'jitc_walk_todense', 'jitc_walk_todense4')
# operations per visit of a stream (the walk's draw, bound and loop, plus
# the weight law: none, Acklam's normal, the uniform hash) and per stream
# set up (its seed hash and ~2 rejection rounds of 2 draws): estimates
# from the code of csrc/light_rng.cuh, 32-bit integer and float32 work
VISIT_OPS = {0: 12, 1: 12 + 60, 2: 12 + 20}
SETUP_OPS = 54


def jitc_operand(shape, kind, gen, device):
    if kind == 'bool':
        return torch.rand(shape, generator=gen, device=device) < 0.05
    if kind == 'events':
        on = torch.rand(shape, generator=gen, device=device) < 0.05
        return torch.where(on, 1.0, -0.5 * torch.rand(
            shape, generator=gen, device=device))
    return torch.randn(shape, generator=gen, device=device)


def jitc_gate(x, event):
    if x.dtype == torch.bool:
        return x.float()
    return (x > 0).float() if event else x.abs()


def check_jitc_kernels(device, n=JITC_N, prob=JITC_PROB):
    phase(f'18 K11-K14 (the JITC walk) vs twin at ({n}, {n}, {prob:.0%}): '
          f'3 laws, strides 32 and 4, corder True/False, event and float, '
          f'B in {{16, 256}} (tolerance: K11, K14 bitwise; products |d| <= '
          f'1e-5 * sum|w x|; gathers bitwise on a repeat)')
    from brainevent_torch._misc import _initialize_conn_length
    from brainevent_torch.jitc import pallas_kernels as jk
    gen = torch.Generator(device=device).manual_seed(18)
    clen = _initialize_conn_length(prob)
    chunk = -(-n // 4)
    worst = dict.fromkeys(JITC_OPS, 0.0)
    plans = {}
    for stride, fn in ((32, jk.walk_plan_setup), (4, jk.walk_plan_setup_mm)):
        s, q, cl = fn(JITC_SEED, clen, n, n, chunk, device=device)
        s2, q2 = jk.jitc_walk_setup.twin(
            torch.empty_like(s), torch.empty_like(q), seed=JITC_SEED, cl=cl,
            n_rows=n, n_cols=n, chunk_size=chunk, stride=stride)
        torch.cuda.synchronize()
        check(torch.equal(s, s2) and torch.equal(q, q2), ('K11', stride))
        plans[stride] = (s, q)
    print(f'K11: both plans ({n} x {plans[32][0].shape[1]} and '
          f'{n} x {plans[4][0].shape[1]} streams) bitwise equal')
    visits = {}
    for law, (code, a, b) in JITC_LAWS.items():
        dense = {}
        for corder in (True, False):
            for op, stride in ((jk.jitc_walk_todense, 32),
                               (jk.jitc_walk_todense4, 4)):
                got = torch.zeros(n, n, device=device)
                op(got, None, None, law=code, a=a, b=b, seed=JITC_SEED,
                   cl=clen, corder=corder)
                want = op.twin(torch.zeros_like(got), None, None, law=code,
                               a=a, b=b, seed=JITC_SEED, cl=clen,
                               corder=corder)
                torch.cuda.synchronize()
                check(torch.equal(got, want), ('K14', law, corder, stride))
                dense[corder, stride] = got.abs()
        visits[law] = int((dense[True, 32] != 0).sum())
        law_kw = dict(law=code, a=a, b=b, seed=JITC_SEED, cl=clen, n_rows=n,
                      n_cols=n, logical_cols=n)
        for corder in (True, False):
            for kind in ('bool', 'events', 'float'):
                event = kind != 'float'
                kw = dict(law_kw, corder=corder, event=event)
                x = jitc_operand(n, kind, gen, device)
                for plan in (plans[32], (None, None)):
                    got = jk.jitc_walk_mv(*plan, x, **kw)
                    want = jk.jitc_walk_mv.twin(*plan, x, **kw)
                    bound = dense[corder, 32] @ jitc_gate(x, event)
                    err = within(got, want, bound, ('K12', law, corder, kind))
                    worst['jitc_walk_mv'] = max(worst['jitc_walk_mv'], err)
                    if corder:
                        again = jk.jitc_walk_mv(*plan, x, **kw)
                        torch.cuda.synchronize()
                        check(torch.equal(got, again), ('K12 repeat', law))
                if kind == 'events':
                    continue
                for nb in (16, 256):
                    B = jitc_operand((n, nb), kind, gen, device)
                    for op, stride, plan in (
                            (jk.jitc_walk_mm, 32, plans[32]),
                            (jk.jitc_walk_mm4, 4, (None, None))):
                        got = op(*plan, B, **kw)
                        want = op.twin(*plan, B, **kw)
                        bound = dense[corder, stride] @ jitc_gate(B, event)
                        err = within(got, want, bound,
                                     (op.name, law, corder, kind, nb))
                        worst[op.name] = max(worst[op.name], err)
                        if corder:
                            again = op(*plan, B, **kw)
                            torch.cuda.synchronize()
                            check(torch.equal(got, again),
                                  (op.name, 'repeat', law))
        print(f'{law}: K14 bitwise in both strides and orders '
              f'({visits[law]} entries, {visits[law] / n / n:.4%}); K12 '
              f'(plan and own setup) and K13 (B = 16, 256) within '
              f'tolerance; gathers bitwise on a repeat')
    return worst, plans, visits, clen


def drive_jitc_surface(device, n=JITC_N, prob=JITC_PROB):
    """The class surface at (n, n, prob): M @ v and v @ M (K11 once, then
    K12 over the cached plan), plan @ B (K13, stride 32), M @ B and X @ M
    (K13, stride 4), M.todense() and M.mm.todense() (K14); each against the
    dense matrix of its mode."""
    import brainevent_torch as bt
    gen = torch.Generator(device=device).manual_seed(19)
    M = bt.JITCNormalR((0.6, 0.06, prob, JITC_SEED), shape=(n, n),
                       corder=True, device=device)
    v = torch.randn(n, generator=gen, device=device)
    B = torch.randn(n, 256, generator=gen, device=device)
    bt.reset_launch_counts()
    D, D4 = M.todense(), M.mm.todense()
    outs = {'M @ v': (M @ v, D @ v), 'v @ M': (v @ M, v @ D),
            'plan @ B': (M.build_walk_plan() @ B, D @ B),
            'M @ B': (M @ B, D4 @ B), 'B.T @ M': (B.T @ M, B.T @ D4)}
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    for what, (got, want) in outs.items():
        rel = float((got - want).abs().max() / want.abs().max())
        check(got.shape == want.shape and rel <= 1e-5, (what, rel))
    want = {'jitc_walk_setup': 2, 'jitc_walk_mv': 2, 'jitc_walk_mm': 1,
            'jitc_walk_mm4': 2, 'jitc_walk_todense': 1,
            'jitc_walk_todense4': 1}
    check({k: counts[k] for k in JITC_OPS} == want, counts)
    print(f'the class surface at ({n}, {n}, {prob:.0%}): M @ v, v @ M, '
          f'plan @ B, M @ B and X @ M within 1e-5 relative of the dense '
          f'products; launches {want}')
    return counts


def jitc_run(net, state, n_steps, start=0, keep=()):
    """*n_steps* JITCNet steps from *state*; the states before the steps
    in *keep* are returned too."""
    kept = []
    for i, t in enumerate(net.times(n_steps, start)):
        if i in keep:
            kept.append((t, state))
        state = net.step(state, t)
    return state, kept


def check_jitc_slice(device):
    phase(f'19 the JITC slice: JITCNet(scale=20) (80k neurons, normal law, '
          f'COBA) and scale=1 (4k), {JITC_STEPS} steps through K12 (20 '
          f'sampled steps against the twin route: spikes bitwise, drives '
          f'within 1e-5 relative), and the scalar law at 80k over '
          f'{JITC_SCALAR_STEPS} steps against the twin loop (spike counts '
          f'equal)')
    import brainevent_torch as bt
    from brainevent_torch.jitc import pallas_kernels as jk
    out = {}
    for label, scale in JITC_SCALES.items():
        bt.reset_launch_counts()
        t0 = time.perf_counter()
        net = bt.JITCNet(scale=scale, weight_law='normal', coba=True,
                         device=device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        setup_counts = bt.launch_counts()
        check(setup_counts['jitc_walk_setup'] == 2, setup_counts)
        state = net.init_state()
        keep = set(range(0, JITC_STEPS, JITC_STEPS // JITC_SAMPLES))
        bt.reset_launch_counts()
        t0 = time.perf_counter()
        final, kept = jitc_run(net, state, JITC_STEPS, keep=keep)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / JITC_STEPS * 1e6
        counts = bt.launch_counts()
        check({k: counts[k] for k in JITC_OPS} == dict(
            dict.fromkeys(JITC_OPS, 0), jitc_walk_mv=2 * JITC_STEPS), counts)
        for x in (final.neurons.v, final.g_e, final.g_i):
            check(x.shape == (net.num,) and bool(torch.isfinite(x).all()),
                  'finite (num,) state')
        rate = float(net.firing_rate_hz(final, JITC_STEPS))
        check(1.0 < rate < 200.0, (label, rate))
        worst = 0.0
        for t, st in kept:
            a = net.step(st, t)
            with twins_on_card([jk.jitc_walk_mv]):
                b = net.step(st, t)
            torch.cuda.synchronize()
            check(torch.equal(a.spike_count, b.spike_count)
                  and torch.equal(a.neurons.v, b.neurons.v), ('spikes', t))
            for ga, gb in ((a.g_e, b.g_e), (a.g_i, b.g_i)):
                rel = float((ga - gb).abs().max() / gb.abs().max().clamp(
                    min=1e-30))
                worst = max(worst, rel)
        check(worst <= 1e-5, ('drives', worst))
        out[label] = dict(net=net, final=final, us=us, rate=rate,
                          counts=counts, setup_counts=setup_counts,
                          build_s=build_s)
        print(f'{label} ({net.num} neurons): plans built in {build_s!r} s '
              f'({setup_counts["jitc_walk_setup"]} K11), {JITC_STEPS} steps '
              f'in {us!r} us/step (host clock), rate {rate!r} Hz, '
              f'{int(final.spike_count.sum())} spikes, '
              f'{counts["jitc_walk_mv"]} K12 launches; {len(kept)} sampled '
              f'steps equal to the twin route, drives within {worst!r} '
              f'relative')
    net = bt.JITCNet(scale=JITC_SCALES['80k'], weight_law='scalar',
                     coba=True, device=device)
    state = net.init_state()
    a, _ = jitc_run(net, state, JITC_SCALAR_STEPS)
    t0 = time.perf_counter()
    with twins_on_card([jk.jitc_walk_mv]):
        b, _ = jitc_run(net, state, JITC_SCALAR_STEPS)
    torch.cuda.synchronize()
    twin_us = (time.perf_counter() - t0) / JITC_SCALAR_STEPS * 1e6
    check(torch.equal(a.spike_count, b.spike_count), 'scalar-law spikes')
    print(f'scalar law at 80k: {JITC_SCALAR_STEPS} steps through K12 and '
          f'through the twin loop on the card give equal spike counts '
          f'({int(a.spike_count.sum())} spikes); the twin loop '
          f'{twin_us!r} us/step')
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


def time_plan_routes(net, spk, mv_kw, device):
    """K12 over the 80k E plan against K12 drawing each stream's setup
    itself, in the three directions of the class surface's 1-D products:
    the event scatter at the net's recorded spikes *spk* and at 10% and
    100% of the rows spiking, the gather and the float scatter. Device ms
    per launch (the gathers also compared bitwise)."""
    from brainevent_torch.jitc import pallas_kernels as jk
    s2, q2, _ = net.plan_e.setup
    n_rows = s2.shape[0]
    gen = torch.Generator(device=device).manual_seed(21)
    event = dict(corder=False, event=True)
    cases = {
        f'event scatter (spk @ M), {int(spk.sum())} spikes': (spk, event),
        'event scatter, 10% spiking': (torch.rand(
            n_rows, generator=gen, device=device) < 0.1, event),
        'event scatter, 100% spiking': (torch.ones(
            n_rows, dtype=torch.bool, device=device), event),
        'gather (M @ v)': (torch.randn(net.num, generator=gen,
                                       device=device),
                           dict(corder=True, event=False)),
        'scatter (u @ M)': (torch.randn(n_rows, generator=gen,
                                        device=device),
                            dict(corder=False, event=False))}
    res = {}
    for what, (x, kw) in cases.items():
        kw = dict(mv_kw, **kw)
        ms = {}
        for route, plan in (('plan', (s2, q2)), ('own setup', (None, None))):
            ms[route] = device_ms(lambda: jk.jitc_walk_mv(*plan, x, **kw), 50)
        if kw['corder']:
            check(torch.equal(jk.jitc_walk_mv(s2, q2, x, **kw),
                              jk.jitc_walk_mv(None, None, x, **kw)),
                  'K12 gather, plan vs own setup')
        res[what] = ms
        print(f'K12 {what} at the 80k E matrix: over the plan {ms["plan"]!r} '
              f'ms, drawing its own setup {ms["own setup"]!r} ms')
    return res


def time_jitc_host(net, state, spike, t, n_rep=1000, n_prof=200):
    """Where a JITCNet step's host time goes at 80k: us per step and per
    propagation (the two K12 wrappers), and cProfile's functions by own
    time over *n_prof* steps."""
    import cProfile
    import pstats
    step_us = host_ms(lambda: net.step(state, t), n_rep) * 1e3
    prop_us = host_ms(lambda: net._propagate(spike), n_rep) * 1e3
    print(f'80k host path: {step_us!r} us per step, of which '
          f'{prop_us!r} us per propagation (two K12 wrappers), '
          f'{n_rep} calls each')
    prof = cProfile.Profile()
    prof.enable()
    jitc_run(net, state, n_prof, JITC_STEPS + 1100)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])
    total = sum(v[2] for v in stats.values()) / n_prof * 1e6
    top = [(f'{f.rsplit("/", 1)[-1]}:{line}:{name}'[-60:], v[1] // n_prof,
            round(v[2] / n_prof * 1e6, 2)) for (f, line, name), v in rows[:15]]
    print(f'80k host path under cProfile: {total!r} us per step; by own '
          f'time (function, calls per step, us per step): {top!r}')


def time_jitc(slice_out, plans, visits, clen, device, n=JITC_N):
    phase('20 JITC timing: device ms per launch (launches queued back to '
          'back) and the twin\'s ms per call; the todense call; K12 over a '
          'plan and drawing its own setup; us/step and where the host '
          'time goes; 10 profiled steps at 80k')
    import brainevent_torch as bt
    from brainevent_torch.jitc import pallas_kernels as jk
    res = {}
    time_jitc_steps(slice_out)
    # K11 and K12 at the main path's shapes: the 80k E plan, and the
    # spikes of the next step from the last timed state
    o = slice_out['80k']
    net, state = o['net'], o['last_state']
    plan = net.plan_e
    s2, q2, cl = plan.setup
    n_rows, L = s2.shape
    chunk = -(-net.num // 4)
    t, spike = recorded_jitc_spikes(net, state)
    spk = spike[:net.n_exc].contiguous()
    law, mv_kw = 1, k12_kwargs(net)
    n_act = int(spk.sum())
    k12_visits = int(jk.jitc_walk_mv.twin(
        s2, q2, spk, **dict(mv_kw, law=0, a=1.0)).sum())
    setup_kw = dict(seed=mv_kw['seed'], cl=cl, n_rows=n_rows,
                    n_cols=net.num, chunk_size=chunk, stride=32)
    se, qe = torch.empty_like(s2), torch.empty_like(q2)
    res['jitc_walk_setup'] = dict(
        ms=device_ms(lambda: jk.jitc_walk_setup(se, qe, **setup_kw), 10),
        plain_ms=host_ms(lambda: jk.jitc_walk_setup.twin(se, qe, **setup_kw),
                         1),
        bytes=8 * s2.numel(), ops=SETUP_OPS * s2.numel(),
        shape=f'80k E plan, {n_rows} x {L} streams')
    res['jitc_walk_mv'] = dict(
        ms=device_ms(lambda: jk.jitc_walk_mv(s2, q2, spk, **mv_kw), 200),
        plain_ms=host_ms(lambda: jk.jitc_walk_mv.twin(s2, q2, spk, **mv_kw),
                         10),
        bytes=n_rows + 8 * n_act * L + 4 * net.num,
        ops=VISIT_OPS[law] * k12_visits,
        shape=f'80k E projection, {n_act} spikes, {k12_visits} visits')
    # K13 and K14 at (n, n, 1%), B = 256, the normal law
    gen = torch.Generator(device=device).manual_seed(20)
    code, a, b = JITC_LAWS['normal']
    B = torch.randn(n, 256, generator=gen, device=device)
    kw = dict(law=code, a=a, b=b, seed=JITC_SEED, cl=clen, n_rows=n,
              n_cols=n, logical_cols=n, corder=True, event=False)
    nv = visits['normal']
    for op, plan in ((jk.jitc_walk_mm, plans[32]),
                     (jk.jitc_walk_mm4, (None, None))):
        res[op.name] = dict(
            ms=device_ms(lambda: op(*plan, B, **kw), 10),
            plain_ms=host_ms(lambda: op.twin(*plan, B, **kw), 2),
            bytes=8 * n * 256 + (8 * plan[0].numel() if plan[0] is not None
                                 else 0),
            ops=nv * (VISIT_OPS[code] + 2 * 256) + (
                0 if plan[0] is not None else SETUP_OPS * n * 16),
            shape=f'({n}, {n}, 1%), B = 256, gather, normal law')
    out = torch.zeros(n, n, device=device)
    for op in (jk.jitc_walk_todense, jk.jitc_walk_todense4):
        dkw = dict(law=code, a=a, b=b, seed=JITC_SEED, cl=clen, corder=True)
        res[op.name] = dict(
            ms=device_ms(lambda: op(out, None, None, **dkw), 10),
            plain_ms=host_ms(lambda: op.twin(out.zero_(), None, None, **dkw),
                             2),
            # the kernel stores the nv weights; the zeros of the output
            # are the wrapper's fill, outside the timed call
            bytes=4 * nv, ops=nv * VISIT_OPS[code] + SETUP_OPS * n * (
                128 if op is jk.jitc_walk_todense else 16),
            shape=f'({n}, {n}, 1%), normal law')
    for name, r in res.items():
        print(f'{name} ({r["shape"]}): device {r["ms"]!r} ms, twin '
              f'{r["plain_ms"]!r} ms')
    # the todense call as a user makes it: the wrapper's fill of the
    # output and K14, against the bound of writing the whole output
    for mode in ('mv', 'mm'):
        ms = device_ms(lambda: bt.jitn(a, b, JITC_PROB, JITC_SEED,
                                       shape=(n, n), matrix_mode=mode,
                                       device=device), 10)
        print(f'jitn todense ({mode} mode, fill + K14, ({n}, {n})): device '
              f'{ms!r} ms, bound {bound(4 * n * n, 0)[0]!r} ms (the '
              f'{4 * n * n / 1e6:.0f} MB output)')
    time_plan_routes(net, spk, mv_kw, device)
    time_jitc_host(net, state, spike, t)
    profile_jitc(net, state)
    return res


def time_jitc_steps(slice_out):
    """JITCNet's us/step (host clock) at each scale of *slice_out*, over
    1000 steps after 100 from the state after the slice's JITC_STEPS;
    each entry gains ``us_timed`` and ``last_state``."""
    for label in ('4k', '80k'):
        o = slice_out[label]
        net, state = o['net'], o['final']
        jitc_run(net, state, 100, JITC_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = jitc_run(net, state, 1000, JITC_STEPS + 100)
        torch.cuda.synchronize()
        o['us_timed'] = (time.perf_counter() - t0) / 1000 * 1e6
        print(f'{label}: {o["us_timed"]!r} us/step over 1000 steps after '
              f'100 warm-up steps (host clock)')
        o['last_state'] = state


def recorded_jitc_spikes(net, state):
    """The time and the spikes of the step after the timed steps."""
    t = net.times(1, JITC_STEPS + 1100)[0]
    return t, net.step(state, t).spike_count != state.spike_count


def profile_jitc(net, state):
    """Kernel us per step over 10 profiled steps after the timed ones."""
    busy_us, wall_us, top = profile_step(
        lambda: jitc_run(net, state, 10, JITC_STEPS + 1100))
    print(f'{net.num // 1000}k, 10 profiled steps: kernels {busy_us / 10!r} '
          f'us of {wall_us / 10!r} us wall per step under the profiler '
          f'(device idle {1 - busy_us / wall_us!r}); largest kernels (name, '
          f'launches, us): {top!r}')
    return busy_us / 10


# -- the dense slice and the event encoders (K15-K18) ---------------------------

# JAX dense/binary.py's benchmark sizes: the (10k, 10k) matvec at 1%, the
# (5000, 5000, B = 128) matmul at 1%; the encoders' (16, 8192) at 1%
# (_benchdata.py)
DENSE_N, DENSE_RATE, DENSE_B = 10_000, 0.01, 128
DENSE_MM = ((5000, 128), (10_000, 128))
DENSE_STEPS = 100
DENSE_OPS = ('dense_event_mv', 'dense_event_mm', 'dense_stdp_pre',
             'dense_stdp_post', 'event_row_count')
ENCODE_SHAPES = ((10_000, 128), (16, 8192))


def dense_spikes(shape, rate, kind, gen, device):
    """bool; or float32 with the active entries in (0.5, 2) and the silent
    ones negative, zero or NaN (the products gate at > 0)."""
    on = torch.rand(shape, generator=gen, device=device) < rate
    if kind == 'bool':
        return on
    x = torch.where(on, 0.5 + 1.5 * torch.rand(shape, generator=gen,
                                                 device=device),
                    -torch.rand(shape, generator=gen, device=device))
    x[::7] = torch.where(on[::7], x[::7], float('nan'))
    return x


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


def check_dense_products(W, device):
    phase(f'21 K15 dense_event_mv / K16 dense_event_mm vs twin at '
          f'({DENSE_N}, {DENSE_N}) and at {DENSE_MM} (tolerance: |d| <= '
          f'1e-5 * sum|W| gate per output; repeats bitwise; K15 s @ W '
          f'bitwise the ascending-row loop; K16 bitwise the ascending-k loop '
          f'at {DENSE_MM[0]})')
    from brainevent_torch.dense import pallas_kernels as dk
    gen = torch.Generator(device=device).manual_seed(21)
    worst = {'dense_event_mv': 0.0, 'dense_event_mm': 0.0}
    W_abs = W.abs()

    def held(op, w, w_abs, s, transpose, what):
        got = op(w, s, transpose)
        want = op.twin(w, s, transpose)
        err = within(got, want, op.twin(w_abs, s, transpose), what)
        again = op(w, s, transpose)
        torch.cuda.synchronize()
        check(torch.equal(got, again), (what, 'repeat'))
        worst[op.name] = max(worst[op.name], err)

    for rate in (0.0, 0.001, 0.01, 0.1, 1.0):
        for kind in ('bool', 'float'):
            s = dense_spikes(DENSE_N, rate, kind, gen, device)
            for transpose in (True, False):
                held(dk.dense_event_mv, W, W_abs, s, transpose,
                     ('K15', rate, kind, transpose))
            got = dk.dense_event_mv(W, s, True)
            want = ordered_event_mm(W, s[:, None], True)[:, 0]
            torch.cuda.synchronize()
            check(torch.equal(got, want), ('K15 s @ W vs the ordered loop',
                                           rate, kind))
        print(f'K15 rate {rate}, bool and float, T and NT: within '
              f'tolerance, repeats bitwise; s @ W bitwise the ascending-row '
              f'loop')
    for n, b in DENSE_MM:
        w, w_abs = W[:n, :n].contiguous(), W_abs[:n, :n].contiguous()
        for kind in ('bool', 'float'):
            S = dense_spikes((n, b), DENSE_RATE, kind, gen, device)
            for transpose in (True, False):
                held(dk.dense_event_mm, w, w_abs, S, transpose,
                     ('K16', n, kind, transpose))
        print(f'K16 ({n}, {n}, B = {b}) at {DENSE_RATE:.0%}, bool and float, '
              f'T and NT: within tolerance, repeats bitwise')
    n, b = DENSE_MM[0]
    w = W[:n, :n].contiguous()
    for rate in (DENSE_RATE, 0.5):
        for kind in ('bool', 'float'):
            S = dense_spikes((n, b), rate, kind, gen, device)
            for transpose in (True, False):
                got = dk.dense_event_mm(w, S, transpose)
                want = ordered_event_mm(w, S, transpose)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      ('K16 vs the ordered loop', rate, kind, transpose))
        print(f'K16 ({n}, {n}, B = {b}) at {rate:.0%}, bool and float, T and '
              f'NT: bitwise the ascending-k loop')
    print(f'max |d|: {worst!r}')
    return worst


def check_dense_stdp_and_encoders(W, device):
    phase(f'22 K17 dense_stdp_pre / dense_stdp_post at ({DENSE_N}, '
          f'{DENSE_N}) and K18 event_row_count at {ENCODE_SHAPES} vs twin, '
          f'and the PyTorch encoders on the card vs the CPU (tolerance: '
          f'bitwise)')
    import brainevent_torch as bt
    from brainevent_torch.dense import pallas_kernels as dk
    from brainevent_torch.events import pallas_kernels as ek
    gen = torch.Generator(device=device).manual_seed(22)
    trace = torch.rand(DENSE_N, generator=gen, device=device)
    for kind in ('bool', 'float'):
        on = torch.rand(DENSE_N, generator=gen, device=device) < DENSE_RATE
        s = on if kind == 'bool' else torch.where(on, -1.0, 0.0)
        if kind == 'float':
            s[on.nonzero()[::3, 0]] = float('nan')      # != 0: an event
        for clip in ((None, None), (-1.0, 1.0)):
            for op, args in ((dk.dense_stdp_pre, (W, s, trace)),
                             (dk.dense_stdp_post, (W, trace, s))):
                got = op(*args, *clip)
                want = op.twin(*args, *clip)
                torch.cuda.synchronize()
                check(torch.equal(got, want), (op.name, kind, clip))
                del got, want
        print(f'K17 pre and post, {kind} spikes at {DENSE_RATE:.0%}, clip '
              f'none and [-1, 1]: bitwise')
    encoders = (bt.binary_1d_array_index_p_call,
                bt.binary_2d_compact_only_p_call,
                bt.binary_2d_array_index_p_call,
                bt.binary_2d_pair_stream_encode_p_call,
                bt.binary_2d_row_sparse_encode_p_call,
                bt.binary_2d_csr_fill_p_call, bt.binary_2d_csc_encode_p_call)
    for shape in ENCODE_SHAPES:
        for kind in ('bool', 'float'):
            on = torch.rand(shape, generator=gen, device=device) < DENSE_RATE
            x = on if kind == 'bool' else torch.where(
                on, torch.tensor([-1.0, float('nan')], device=device)[
                    torch.randint(2, shape, generator=gen, device=device)],
                0.0)
            got = ek.event_row_count(x)
            torch.cuda.synchronize()
            check(torch.equal(got, ek.event_row_count_twin(x)),
                  ('K18', shape, kind))
            xc = x.cpu()
            indptr = torch.cat([torch.zeros(1, dtype=torch.int32),
                                torch.cumsum(got.cpu(), 0, dtype=torch.int32)])
            for fn in encoders:
                if fn is bt.binary_1d_array_index_p_call:
                    args_d, args_c = (x[0],), (xc[0],)
                elif fn is bt.binary_2d_csr_fill_p_call:
                    args_d, args_c = (x, indptr.to(device)), (xc, indptr)
                else:
                    args_d, args_c = (x,), (xc,)
                for a, b in zip(fn(*args_d), fn(*args_c)):
                    check(torch.equal(a.cpu(), b), (fn.__name__, shape, kind))
        print(f'K18 at {shape}, bool and float (negatives, NaN): equal to the '
              f'twin; the seven PyTorch encoders on the card equal to the CPU')
    return 0.0


def dense_step_loop(W, n_steps, device, *, bounds=False):
    """The dense slice: per step the event products both ways, the trace
    decay, STDP on-pre and on-post with clip [-1, 1], ``W @ S`` with ``S``
    (n, 128), and the encoders of ``S``. Returns the final matrix, every
    step's products and, with *bounds*, their ``sum|W| gate`` bounds."""
    import brainevent_torch as bt
    from brainevent_torch.dense import pallas_kernels as dk
    gen = torch.Generator(device=device).manual_seed(23)
    n = W.shape[0]
    pre_tr = torch.zeros(n, device=device)
    post_tr = torch.zeros(n, device=device)
    outs, bnds = [], []
    for _ in range(n_steps):
        pre = torch.rand(n, generator=gen, device=device) < DENSE_RATE
        post = torch.rand(n, generator=gen, device=device) < DENSE_RATE
        S = torch.rand(n, DENSE_B, generator=gen, device=device) < DENSE_RATE
        a = bt.BinaryArray(pre) @ W
        b = W @ bt.BinaryArray(post)
        pre_tr = pre_tr * 0.95 + pre
        post_tr = post_tr * 0.95 + post
        W = W.update_on_pre(pre, post_tr, -1.0, 1.0)
        W = W.update_on_post(pre_tr, post, -1.0, 1.0)
        c = W @ bt.BinaryArray(S)
        cb = bt.CompactBinary.from_array(S)
        indices, indptr = bt.binary_2d_csr_encode_p_call(S)
        outs.append((a, b, c, cb.n_active, indptr[-1:]))
        if bounds:
            w_abs = W.data.abs()
            bnds.append((dk.dense_event_mv.twin(w_abs, pre, True),
                         dk.dense_event_mv.twin(w_abs, post, False),
                         dk.dense_event_mm.twin(w_abs, S, False)))
            del w_abs
    return W, outs, bnds


def check_dense_slice(W0, device):
    phase(f'23 the dense slice on the card at ({DENSE_N}, {DENSE_N}) '
          f'(100M weights): {DENSE_STEPS} steps of s @ W and W @ s at '
          f'{DENSE_RATE:.0%}, trace decay, STDP on-pre / on-post with clip '
          f'[-1, 1], W @ S (B = {DENSE_B}) and the encoders of S, through '
          f'the kernels and through the twins (W.data bitwise; products '
          f'within 1e-5 * sum|W| gate)')
    import brainevent_torch as bt
    from brainevent_torch.ops.core import REGISTRY
    ops = [REGISTRY[name] for name in DENSE_OPS]
    W = bt.Dense(W0)
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    W_k, outs_k, _ = dense_step_loop(W, DENSE_STEPS, device)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DENSE_STEPS * 1e3
    counts = bt.launch_counts()
    want = {'dense_event_mv': 2 * DENSE_STEPS, 'dense_event_mm': DENSE_STEPS,
            'dense_stdp_pre': DENSE_STEPS, 'dense_stdp_post': DENSE_STEPS,
            'event_row_count': DENSE_STEPS}
    check({k: counts[k] for k in DENSE_OPS} == want, counts)
    t0 = time.perf_counter()
    with twins_on_card(ops):
        W_t, outs_t, bnds = dense_step_loop(W, DENSE_STEPS, device,
                                            bounds=True)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) / DENSE_STEPS * 1e3
    check(torch.equal(W_k.data, W_t.data), 'final W.data')
    check(bool(torch.isfinite(W_k.data).all()) and W_k.data.shape == (
        DENSE_N, DENSE_N), 'W.data finite')
    worst = 0.0
    for ok, ot, bd in zip(outs_k, outs_t, bnds):
        for a, b, bound_ in zip(ok[:3], ot[:3], bd):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                  'product shape')
            worst = max(worst, within(a, b, bound_, 'dense slice product'))
        for a, b in zip(ok[3:], ot[3:]):
            check(torch.equal(a, b), 'encoder counts')
    clipped = float((W_k.data.abs() == 1.0).float().mean())
    print(f'{DENSE_STEPS} steps: W.data bitwise equal to the twin run '
          f'({clipped!r} of the weights on a clip bound), products within '
          f'tolerance (max |d| {worst!r}); launches per step: '
          f'{ {k: counts[k] / DENSE_STEPS for k in DENSE_OPS} }; '
          f'{step_ms!r} ms/step through the kernels, {twin_ms!r} ms/step '
          f'through the twins (host clock)')
    del outs_k, outs_t, bnds, W_t
    # a backward through W @ BinaryArray(float spikes), with respect to
    # the weights and the spikes (the surrogate-linear rule)
    gen = torch.Generator(device=device).manual_seed(231)
    x = dense_spikes(DENSE_N, DENSE_RATE, 'float', gen, device)
    x = torch.nan_to_num(x)
    ct = torch.randn(DENSE_N, generator=gen, device=device)
    grads = []
    for twin in (False, True):
        data = W_k.data.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        with twins_on_card(ops if twin else []):
            y = bt.Dense(data) @ bt.BinaryArray(xx)
            grads.append((y.detach(), *torch.autograd.grad(y, (data, xx),
                                                           ct)))
        del data
    (yk, gwk, gxk), (yt, gwt, gxt) = grads
    torch.cuda.synchronize()
    check(torch.equal(gwk, gwt) and torch.equal(gxk, gxt), 'dW and dx')
    within(yk, yt, bt.Dense(W_k.data.abs()) @ bt.BinaryArray(x), 'y')
    print('backward through W @ BinaryArray(float spikes): dW (the outer '
          'product with the gate) and dx (W.T @ ct) bitwise the twin '
          'route\'s, y within tolerance')
    del grads, gwk, gwt
    t = dense_slice_times(W_k, device, 0)
    print(f'10 profiled steps: kernels {t["kernel_us"]!r} us of '
          f'{t["wall_us"]!r} us wall per step under the profiler (device '
          f'idle {t["idle"]!r} there; '
          f'{1 - t["kernel_us"] / (step_ms * 1e3)!r} of the unprofiled '
          f'steps); largest kernels (name, launches, us): {t["top"]!r}')
    return counts, step_ms, W_k


def dense_slice_times(W, device, n_steps):
    """*n_steps* steps of the dense slice from the matrix *W* on the host
    clock (ms a step; none for 0), then 10 profiled steps: kernel and wall
    time a step, idle share and the largest kernels."""
    step_ms = None
    if n_steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense_step_loop(W, n_steps, device)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    busy_us, wall_us, top = profile_step(
        lambda: dense_step_loop(W, 10, device))
    return dict(ms=step_ms, kernel_us=busy_us / 10, wall_us=wall_us / 10,
                idle=1 - busy_us / wall_us, top=top)


def time_k15(W, s):
    """K15 both ways on the (n, n) weights *W* and the bool spikes *s*:
    device ms per launch, the twin's ms, the bytes and operations of the
    bound, and ``torch.matmul`` of the float gate (TF32 off)."""
    from brainevent_torch.dense import pallas_kernels as dk
    torch.backends.cuda.matmul.allow_tf32 = False
    n, n_act, g = W.shape[0], int(s.sum()), s.float()
    out = {}
    for name, transpose, lib, n_bytes in (
            ('dense_event_mv T', True, lambda: torch.matmul(g, W),
             4 * n * n_act),
            ('dense_event_mv NT', False, lambda: torch.matmul(W, g),
             32 * n * n_act)):
        r = dict(ms=device_ms(lambda: dk.dense_event_mv(W, s, transpose),
                              200),
                 plain_ms=host_ms(lambda: dk.dense_event_mv.twin(
                     W, s, transpose), 20),
                 library_ms=device_ms(lib, 200),
                 bytes=n_bytes + n + 4 * n, ops=n * n_act)
        out[name] = r
        print(f'{name}: device {r["ms"]!r} ms, twin {r["plain_ms"]!r} ms, '
              f'library {r["library_ms"]!r} ms, bound '
              f'{bound(r["bytes"], r["ops"])!r}')
    return out


def time_dense_kernels(W, device):
    phase('24 dense and encoder timing: device ms per launch (launches '
          'queued back to back), the twin\'s ms per call, the bound, and '
          'one PyTorch call computing the same function (TF32 off)')
    from brainevent_torch.dense import pallas_kernels as dk
    from brainevent_torch.events import pallas_kernels as ek
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(24)
    n, b = DENSE_N, DENSE_B
    s = torch.rand(n, generator=gen, device=device) < DENSE_RATE
    S = torch.rand(n, b, generator=gen, device=device) < DENSE_RATE
    x = torch.rand(*ENCODE_SHAPES[0], generator=gen, device=device) < \
        DENSE_RATE
    trace = torch.rand(n, generator=gen, device=device)
    g = s.float()
    out = {}

    def timed(name, op, args, reps, reps_twin, library, n_bytes, n_ops):
        r = dict(ms=device_ms(lambda: op(*args), reps),
                 plain_ms=host_ms(lambda: op.twin(*args), reps_twin),
                 library_ms=(device_ms(library, reps) if library else None),
                 bytes=n_bytes, ops=n_ops)
        out[name] = r
        print(f'{name}: device {r["ms"]!r} ms, twin {r["plain_ms"]!r} ms, '
              f'library {r["library_ms"]!r} ms, bound '
              f'{bound(n_bytes, n_ops)!r}')

    out.update(time_k15(W, s))
    # K16 at the slice's 1% (W @ S, the main path) and at 10% and 50%,
    # both directions: the event form's adds grow as m n k rate. The bytes
    # are W once (the rows some column needs, transpose), S and Y.
    for rate in (DENSE_RATE, 0.1, 0.5):
        Sr = S if rate == DENSE_RATE else torch.rand(
            n, b, generator=gen, device=device) < rate
        Gr, nnz_r = Sr.float(), int(Sr.sum())
        rows_needed = int(Sr.any(dim=1).sum())
        for transpose in (False, True):
            name = f'dense_event_mm {"T" if transpose else "NT"} {rate:.0%}'
            timed(name, dk.dense_event_mm, (W, Sr, transpose), 10, 5,
                  (lambda G_=Gr: torch.matmul(W.T, G_)) if transpose
                  else (lambda G_=Gr: torch.matmul(W, G_)),
                  4 * n * (rows_needed if transpose else n) + n * b
                  + 4 * n * b, 2 * nnz_r * n)
    out['dense_event_mm'] = out[f'dense_event_mm NT {DENSE_RATE:.0%}']
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
    return out


# -- the EI strategies: the dense count table and K19 ---------------------------------

DENSE_SIM_STEPS = 2000
# (label, EINet scale, COBA) of the dense strategy's runs against mxu3
DENSE_SIM_NETS = (('4k', 1.0, True), ('4k', 1.0, False), ('40k', 10.0, True))
DENSE_TIME_WARM = 1000
# (label, EINet scale) of K19's checks and timings: the two sizes of the runs
K19_NETS = (('4k', 1.0), ('40k', 10.0))


def int32_table_net(device):
    """A 4k network of 300 connections a neuron with the edge 5 -> 17
    290 times: its count table needs int32."""
    import brainevent_torch as bt
    rng = np.random.default_rng(250)
    conn = rng.integers(0, 4000, (4000, 300)).astype(np.int32)
    conn[5, :290] = 17
    return bt.EINet(scale=1.0, n_conn=300, conn_all=conn, device=device)


def spike_list(num, n_act, rng, device):
    """A permutation of the neurons with ids outside ``[0, num)`` among
    its first entries, and a length of *n_act*."""
    ids = rng.permutation(num).astype(np.int32)
    ids[1:min(num, 400):7] = -3
    ids[2:min(num, 400):11] = num + 5
    return (torch.from_numpy(ids).to(device),
            torch.tensor([n_act], dtype=torch.int32, device=device))


def check_k19(device):
    phase('25 K19 einet_dense_hits vs its twin and vs K2 at 4k and 40k, uint8 '
          'and int32 tables, spike lists of 0, 1, 1% and 100% of the neurons '
          'with out-of-range ids (tolerance: exact, bitwise K2)')
    import brainevent_torch as bt
    from brainevent_torch.models import sim
    from brainevent_torch.ops import scatter as sc
    rng = np.random.default_rng(25)
    worst = 0.0
    nets = [(label, bt.EINet(scale=scale, device=device))
            for label, scale in K19_NETS]
    nets.append(('4k int32', int32_table_net(device)))
    for label, net in nets:
        num = net.num
        table = sim.dense_count_table(net)
        check(table.dtype == (torch.int32 if 'int32' in label
                              else torch.uint8), (label, table.dtype))
        for n_act in (0, 1, num // 100, num):
            ids, n_ids = spike_list(num, n_act, rng, device)
            start = torch.from_numpy(rng.integers(0, 9, (2, num)).astype(
                np.int32)).to(device)
            got = sim.einet_dense_hits(ids, n_ids, table, net.n_exc,
                                       start.clone())
            want = sim.einet_dense_hits_twin(ids, n_ids, table, net.n_exc,
                                             start.clone())
            k2 = sc.event_count_scatter(ids, n_ids, net.conn_all, net.n_exc,
                                        start.clone())
            torch.cuda.synchronize()
            worst = max(worst, float((got - want).abs().max()))
            check(torch.equal(got, want), ('K19 vs twin', label, n_act))
            check(torch.equal(got, k2), ('K19 vs K2', label, n_act))
        print(f'{label} ({num} neurons, {table.dtype} table of '
              f'{table.numel() * table.element_size()} bytes): n_act 0, 1, '
              f'{num // 100}, {num}: equal to the twin and to K2')
        del table
    return worst


def run_strategy(net, state, n_steps, strategy, ref, inp=20.0):
    """``einet_pallas_sim(strategy=...)`` from *state*, held against *ref*
    (the mxu3 route's five outputs): all five bitwise; every name,
    dense included (K21's table instance), launches K21 once, and K1, K2
    and K19 never run. Returns the outputs and the launch counts."""
    import brainevent_torch as bt
    bt.reset_launch_counts()
    out = bt.einet_pallas_sim(net, state, n_steps, inp, strategy=strategy)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    check(counts['einet_sim'] == 1 and counts['einet_step'] == 0
          and counts['einet_dense_hits'] == 0
          and counts['event_count_scatter'] == 0, (strategy, counts))
    for x, y in zip(out, ref):
        check(x.dtype == y.dtype and torch.equal(x, y),
              (strategy, 'bitwise mxu3'))
    return out, counts


def dense_k19(net, state, n_steps, inp=20.0):
    """The dense strategy's parent route, the loop of K1 and K19 (2n + 1
    launches), as ``einet_pallas_sim_dense`` runs it: the table built,
    then ``EINet._simulate`` with K1 as its step op, which routes the
    table's hits through K19. The package keeps this route above the
    table instance's capacity, which no card's memory reaches (the uint8
    table of 405k neurons is 164 GB). Returns the five outputs."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.models import sim
    out = net._simulate(state, net.times(n_steps), inp,
                        step_op=nw.einet_step,
                        table=sim.dense_count_table(net))
    return (out.neurons.v, out.neurons.t_last, out.g_e, out.g_i,
            out.spike_count)


def run_dense_k19(net, state, n_steps, ref, inp=20.0):
    """:func:`dense_k19` from *state*: all five outputs bitwise *ref*
    (mxu3's), K1 ``n_steps + 1`` and K19 ``n_steps`` launches, K21 and K2
    none. Returns the launch counts."""
    import brainevent_torch as bt
    bt.reset_launch_counts()
    out = dense_k19(net, state, n_steps, inp)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    check(counts['einet_sim'] == 0 and counts['einet_step'] == n_steps + 1
          and counts['einet_dense_hits'] == n_steps
          and counts['event_count_scatter'] == 0, ('K1 + K19', counts))
    for x, y in zip(out, ref):
        check(x.dtype == y.dtype and torch.equal(x, y),
              ('K1 + K19', 'bitwise mxu3'))
    return counts


def check_dense_strategies(device):
    phase(f'26 the strategies: einet_pallas_sim(strategy=\'dense\') (K21\'s '
          f'table instance, one launch) against \'mxu3\' (K21), COBA and '
          f'CUBA 4k and COBA 40k, {DENSE_SIM_STEPS} steps; the parent\'s '
          f'route (K1 + K19); an int32 table; a burst; every other strategy '
          f'at 4k (all five outputs bitwise); the table instances\' '
          f'occupancy and capacity')
    import brainevent_torch as bt
    from brainevent_torch.models import sim
    n_steps = DENSE_SIM_STEPS
    launches = None
    for label, scale, coba in DENSE_SIM_NETS:
        net = bt.EINet(scale=scale, coba=coba, device=device)
        state = net.init_state()
        t0 = time.perf_counter()
        table = sim.dense_count_table(net)
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
        n_bytes = table.numel() * table.element_size()
        del table
        ref = bt.einet_pallas_sim(net, state, n_steps, strategy='mxu3')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = run_strategy(net, state, n_steps, 'dense', ref)
        t_run = time.perf_counter() - t0
        for x in out[:4]:
            check(x.shape == (net.num,) and bool(torch.isfinite(x).all()),
                  'finite (num,) state')
        rate = float(out[4].float().mean()) / (n_steps * net.dt * 1e-3)
        check(5.0 < rate < 200.0, rate)
        k19 = run_dense_k19(net, state, n_steps, ref)
        if label == '4k' and coba:
            launches = k19, counts
        print(f'{"COBA" if coba else "CUBA"} {label}: dense bitwise mxu3 '
              f'({int(out[4].sum())} spikes, rate {rate!r} Hz), one K21 '
              f'launch, no K1, K2 or K19; the parent\'s route '
              f'{k19["einet_step"]} K1 + {k19["einet_dense_hits"]} K19, '
              f'bitwise mxu3; table {n_bytes} bytes built in {t_table!r} s; '
              f'{t_run / n_steps * 1e6!r} us/step with the build and the '
              f'check (host clock)')
    net = int32_table_net(device)
    state = net.init_state()
    ref = bt.einet_pallas_sim(net, state, n_steps, strategy='mxu3')
    out, _ = run_strategy(net, state, n_steps, 'dense', ref)
    run_dense_k19(net, state, n_steps, ref)
    print(f'int32 table ({net.num} neurons, 300 connections, one edge 290 '
          f'times): dense bitwise mxu3 on K21 and on K1 + K19 '
          f'({int(out[4].sum())} spikes)')
    # a burst: every neuron driven over threshold (tests/test_models.py:222)
    net = bt.EINet(scale=0.064, seed=3, device=device)
    state = net.init_state()
    ref = bt.einet_pallas_sim(net, state, 10, 500.0, strategy='mxu3')
    out, _ = run_strategy(net, state, 10, 'dense', ref, inp=500.0)
    run_dense_k19(net, state, 10, ref, inp=500.0)
    check(int(out[4].sum()) > 100, 'burst fires')
    print(f'burst (inp 500, 10 steps, {net.num} neurons): '
          f'{int(out[4].sum())} spikes, bitwise mxu3')
    net = bt.EINet(scale=1.0, device=device)
    state = net.init_state()
    ref = bt.einet_pallas_sim(net, state, n_steps, strategy='mxu3')
    for strategy in ('chain', 'mxu', 'mxu2', 'mxu4', 'mxu5', 'mxu6'):
        run_strategy(net, state, n_steps, strategy, ref)
    print(f'chain, mxu, mxu2, mxu4, mxu5, mxu6 at 4k, {n_steps} steps: '
          f'bitwise mxu3, one K21 launch each')
    print_sim_capacity(device)
    return launches


def print_sim_capacity(device):
    """K21's co-resident blocks by source and NPT instance, and each
    source's capacity; a table instance's capacity must exceed the
    largest table the card's memory holds."""
    from brainevent_torch.models import networks as nw
    total = torch.cuda.get_device_properties(device).total_memory
    for dtype, npts in nw.SIM_SOURCE_NPT.items():
        blocks = {k: nw.einet_sim_max_blocks(device, k, dtype) for k in npts}
        cap = nw.einet_sim_capacity(device, dtype)
        line = (f'K21 over {"conn" if dtype is None else dtype}: blocks by '
                f'NPT {blocks}, capacity {cap} neurons')
        if dtype is not None:
            item = torch.empty((), dtype=dtype).element_size()
            fits = math.isqrt(total // item)
            check(cap > fits, ('table capacity', dtype, cap, fits))
            line += (f'; the largest table {total} bytes of device memory '
                     f'hold: {fits} neurons')
        print(line)


def recorded_spikes(net, state, steps_done, device):
    """The spike list of one K1 step from *state* (a run's final state,
    *steps_done* steps in): ``(ids, n_ids)`` as K19 reads them."""
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
    """COBA us/step (host clock, the table build of each call included)
    of the dense strategy through K21's table instance and through K1 +
    K19 (:func:`dense_k19`), in turns K21, K1 + K19, K1 + K19,
    K21, from the state *warm* dense steps in; each run bitwise the
    other route's. Returns ``({route: [us, us]}, K21's final state)``."""
    import brainevent_torch as bt
    state = bt.einet_pallas_sim(net, net.init_state(), warm,
                                strategy='dense')
    state = bt.EINetState(bt.LIFRefState(state[0], state[1]), *state[2:])
    runs = {'K21': [], 'K1 + K19': []}
    outs = {}
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
    check_equal_fields(outs['K21'], outs['K1 + K19'], ('dense timed runs',
                                                       net.num))
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
    want = [x.clone() for x in state_fields(state)]
    times = torch.tensor(net.times(start + EI_STEPS)[start:],
                         dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nw.einet_sim_twin(*want, net.conn_all, times, net.step_params(),
                      net.n_exc, table)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check_equal_fields(got, want, 'table instance line vs twin')
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    new = got[4] - state.spike_count
    n_bytes = (40 * net.num + 4 * EI_STEPS + net.num * table.element_size()
               * int((new > 0).sum()))
    n_ops = 20 * net.num * EI_STEPS + net.conn_all.shape[1] * int(new.sum())
    print(f'K21 table instance, one launch of {EI_STEPS} steps at COBA 4k: '
          f'device {ms!r} ms, twin {plain_ms!r} ms, bitwise; '
          f'{int(new.sum())} spikes, bound {bound(n_bytes, n_ops)!r}')
    return dict(ms=ms, plain_ms=plain_ms, bytes=n_bytes, ops=n_ops, err=err)


# (label, EINet scale, steps timed, warm-up steps) of phase 27's dense runs
DENSE_TIMES = (('4k', 1.0, 100_000, 1000), ('40k', 10.0, 20_000, 1000))


def time_dense(device):
    phase('27 dense timing: COBA 4k and 40k us/step, the dense strategy '
          'through K21\'s table instance and through K1 + K19 in turns, mxu3 '
          'beside; the table instance\'s device us/step by NPT; K19 device '
          'ms per launch (launches queued back to back) at 4k and 40k on '
          'recorded spike lists, its twin, its bound, and torch.matmul of '
          'the (2, num) float32 masks with the float32 table (TF32 off)')
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
        steps_done = n_steps     # the timed run's clock started at 0
        num = net.num
        table = sim.dense_count_table(net)
        by_npt = {}
        for k in nw.SIM_SOURCE_NPT[table.dtype]:
            need = -(-num // (k * nw.SIM_BLOCK))
            if need > nw.einet_sim_max_blocks(device, k, table.dtype):
                continue
            for walk in ('block', 'grid'):
                ms, _ = sim_device_ms(net, final, EI_STEPS, steps_done,
                                      table=table, npt=k,
                                      grid_walk=walk == 'grid')
                by_npt[f'{k} {walk}'] = ms / EI_STEPS * 1e3
        conn_ms, _ = sim_device_ms(net, final, EI_STEPS, steps_done)
        npt, blocks = nw.einet_sim_grid(num, device, table.dtype)
        walk = 'grid' if nw.table_grid_walk(table) else 'block'
        print(f'COBA {label} over {n_steps} steps after {warm} (rate '
              f'{rate!r} Hz), us/step on the host clock: dense through K21 '
              f'{us["dense"]!r}, through K1 + K19 {us["K1 + K19"]!r} (in '
              f'turns), mxu3 {us["mxu3"]!r}; device us/step over {EI_STEPS} '
              f'steps on from there: the table instance by NPT and walk '
              f'{by_npt!r} (the package runs NPT {npt}, {blocks} blocks, the '
              f'{walk} walk), K21 over conn '
              f'{conn_ms / EI_STEPS * 1e3!r}')
        ids, n_ids = recorded_spikes(net, state_fields(final), steps_done,
                                     device)
        n_act = int(n_ids)
        counts = torch.zeros(2, num, dtype=torch.int32, device=device)
        reps, reps_twin = (500, 100) if num < 40_000 else (200, 20)
        args = (ids, n_ids, table, net.n_exc, counts)
        ms = device_ms(lambda: sim.einet_dense_hits(*args), reps)
        twin_ms = host_ms(lambda: sim.einet_dense_hits_twin(*args),
                          reps_twin)
        sel = ids[:n_act].long()
        masks = torch.zeros(2, num, device=device)
        masks[0, sel[sel < net.n_exc]] = 1.0
        masks[1, sel[sel >= net.n_exc]] = 1.0
        table_f32 = table.float()
        lib_ms = device_ms(lambda: torch.matmul(masks, table_f32), 50)
        del table_f32
        n_bytes = n_act * (num * table.element_size() + 4) + 8 * num
        res[label] = dict(ms=ms, plain_ms=twin_ms, library_ms=lib_ms,
                          bytes=n_bytes, us_per_step=us, n_act=n_act,
                          table_device_us_by_npt=by_npt,
                          conn_device_us=conn_ms / EI_STEPS * 1e3)
        print(f'K19 at {label} ({n_act} spikes of {num}): device {ms!r} ms, '
              f'twin {twin_ms!r} ms, torch.matmul {lib_ms!r} ms, bound '
              f'{bound(n_bytes, 0)!r}')
        if label == '4k':
            res['table'] = table_sim_line(net, final, steps_done, table,
                                          device)
        del table
    res['walks'] = time_walks(device)
    return res


# EINet scales of phase 27's walk sweep (6k-30k neurons): between the 4k
# table, which the L2 cache holds, and the 40k one
WALK_SCALES = (1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 7.5)


def time_walks(device):
    """The table instance's device us/step at NPT 1 by walk, each block its
    own rows or the whole grid, in turns block, grid, grid, block, over
    EI_STEPS COBA steps on from DENSE_TIME_WARM mxu3 steps, at each of
    :data:`WALK_SCALES`; the walks bitwise each other. Returns ``{num:
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
        check_equal_fields(got['block'], got['grid'], ('walks', net.num))
        spikes = int((got['grid'][4] - final.spike_count).sum()) / EI_STEPS
        _, blocks = nw.einet_sim_grid(net.num, device, table.dtype)
        choice = 'grid' if nw.table_grid_walk(table) else 'block'
        res[net.num] = dict(us=us, spikes_per_step=spikes, blocks=blocks,
                            choice=choice)
        print(f'COBA {net.num} ({table.numel()} byte table, {blocks} blocks '
              f'at NPT 1, {spikes!r} spikes a step): table instance device '
              f'us/step, block walk {us["block"]!r}, grid walk '
              f'{us["grid"]!r} (in turns, bitwise); the package walks by '
              f'{choice}')
        del table, net, final, out
    return res


def c8_entries(device, gen, w_dtype):
    """``name -> (fn(spikes), spike shape, op name, nonzero gate, fn over
    |W| in float32 or None where the result is exact)`` for each public
    entry of K5-K8, K10, K12, K13 and K15-K18, weights in *w_dtype*."""
    import brainevent_torch as bt
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
    from brainevent_torch.ops.core import REGISTRY
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
            check(REGISTRY[op].launches == before + 1, (name, dtype, 'launch'))
            check(got.dtype == want.dtype and torch.equal(got, want),
                  (name, dtype))
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
    from brainevent_torch.ops.core import REGISTRY
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
            check(got.dtype == dtype == want.dtype, (name, dtype))
            check(launched == 1, (name, dtype, launched))
            g, t = got.float(), want.float()
            tol = torch.finfo(dtype).eps * torch.maximum(g.abs(), t.abs())
            if fn_abs is not None:
                tol = tol + 1e-5 * fn_abs(s)
            check(bool(((g - t).abs() <= tol).all()), (name, dtype))
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0),
                                    float((g - t).abs().max()))
    return worst


def c8_float64_weights(device, gen):
    """float64 weights on the card (C10): one launch of the kernel's
    ``double`` instance at each weighted entry of :func:`c8_entries`, the
    result float64 and within ``1e-12 * sum|w| gate`` of the float64 twin
    (bitwise at the exact entries). Returns the number of entries and the
    largest error."""
    from brainevent_torch.ops.core import REGISTRY
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
    check(got.dtype == torch.float64 == want.dtype, (name, got.dtype))
    check(launched == 1, (name, 'float64', launched))
    err = (got - want).abs()
    if fn_abs is None:
        check(torch.equal(got, want), (name, 'float64 bitwise'))
    else:
        check(bool((err <= 1e-12 * fn_abs()).all()),
              (name, 'float64', float(err.max())))
    return float(err.max())


def c10_float_products(device, gen):
    """The float64 kernels the binary matrix does not reach: ``csrmv``
    both ways and ``csrmm`` (K7, K8, K10 on a float64 operand), the CSR
    STDP update and a weight gradient (K9), each one launch of its
    ``double`` instance against the float64 twin: K9 bitwise, the sums
    within ``1e-12 * sum|w x|``. Returns the number of cases and the
    largest error."""
    import brainevent_torch as bt
    from brainevent_torch.ops.core import REGISTRY
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
    import brainevent_torch as bt
    from brainevent_torch.ops import scatter as sc
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
        check(op.launches - before == 1 and got.dtype == dtype,
              (dtype, op.launches - before, got.dtype))
        with twins_on_card([op]):
            want = bt.event_scatter_add(targets, values, n_out, mask=mask)
        keep = mask & (targets >= 0) & (targets < n_out)
        cpu = torch.zeros(n_out, dtype=dtype).index_add_(
            0, targets[keep].long().cpu(), values[keep].cpu())
        if dtype.is_floating_point:
            err = float((got - want).abs().max())
            scale = torch.zeros(n_out, dtype=dtype, device=device).index_add_(
                0, targets[keep].long(), values[keep].abs())
            check(bool(((got - want).abs() <= 1e-12 * scale).all()),
                  ('float64 sum', err))
            worst = max(worst, err)
        else:
            check(torch.equal(got, want) and torch.equal(got.cpu(), cpu),
                  (dtype, 'equal to the twin and to index_add_'))
    print(f'event_scatter_add: float64 (C13) within 1e-12 * sum|v| of the '
          f'float64 twin (max |d| {worst!r}); int32, int64, int8, int16 and '
          f'uint8 outputs (C14) bitwise the twin and index_add_ in their '
          f'dtype; one launch each')
    return len(cases), worst


def check_c8(device):
    phase('28 dtypes at the public entries of K5-K10, K12, K13, K15-K18: '
          'spikes in nine dtypes bitwise the bool spikes\' result through '
          'the kernel; float16/bfloat16 weights within 1 ulp of the twin '
          '(on the widened weights, rounded) plus the float32 bound; '
          'float64 weights (C10) through each kernel\'s double instance, '
          'within 1e-12 * sum|w x| of the float64 twin, bitwise where exact; '
          'event_scatter_add in float64 (C13) and integer outputs (C14)')
    gen = torch.Generator(device=device).manual_seed(28)
    n_checked = c8_spike_dtypes(device, gen)
    print(f'spikes: {n_checked} entry x dtype cases bitwise the bool '
          f'spikes\' result, each through its kernel')
    worst = c8_half_weights(device, gen)
    n64, err64 = c8_float64_weights(device, gen)
    nf, errf = c10_float_products(device, gen)
    print(f'weights float16 and bfloat16 within tolerance (max |d| '
          f'{worst!r}); float64 through the double instances at {n64} '
          f'binary entries (max |d| {err64!r}) and {nf} float product, '
          f'STDP and gradient cases (max |d| {errf!r}), one launch each')
    c13_c14_scatter(device, gen)


# -- the multi-device layer: K20, ShardedEINet, the sharded ops (phases 29-31) --

# (label, EINet scale) of phases 29 and 30: COBA 4k and the 400k network of
# the repo's acceptance model (80 targets a neuron, a 128 MB table)
SHARD_NETS = (('4k', 1.0), ('400k', 100.0))
K20_SHARDS = 4
SHARD_STEPS, SHARD_TIME_STEPS, SHARD_TIME_WARM = 2000, 5000, 200
# phase 31: the ELL and CSR shapes, and the 80k E projection of
# JITCNet(scale=20) (64,000 presynaptic rows x 80,000 targets)
SHARD_OPS_N, SHARD_CSR = 20_000, (4000, 3000)
SHARD_JITC = (64_000, 80_000)
# every collective of torch.distributed a step could call
COLLECTIVES = ('all_reduce', 'reduce_scatter_tensor', 'reduce_scatter',
               'reduce_scatter_single', 'all_gather_into_tensor',
               'all_gather', 'all_gather_single', 'broadcast', 'reduce',
               'all_to_all', 'all_to_all_single', 'send', 'recv', 'barrier')


@contextlib.contextmanager
def collective_log():
    """Count the calls of :data:`COLLECTIVES` on ``torch.distributed``
    (wrapped here, not in the package) and the bytes of each call's input:
    yields the list of ``(name, bytes)``."""
    import torch.distributed as dist
    calls = []
    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}

    def wrap(name, fn):
        def call(*args, **kwargs):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            src = ts[1] if len(ts) > 1 else (ts or [None])[0]
            calls.append((name, 0 if src is None
                          else src.numel() * src.element_size()))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


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


def k20_vs_k2(net, ids, n_ids, device, n_dev=K20_SHARDS):
    """K20 on *n_dev* shards of *net* for one spike list: each shard's
    full partial bitwise its twin, their sum and the shard-major buffer
    bitwise K2's counts. Returns the largest error against the twin."""
    from brainevent_torch.ops import scatter as sc
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
        check(torch.equal(got, want), ('K20 vs twin', num, r))
        total += got[0]
    torch.cuda.synchronize()
    check(torch.equal(total, k2), ('K20 4-shard sum vs K2', num))
    check(torch.equal(major.transpose(0, 1).reshape(2, num), k2),
          ('K20 shard-major vs K2', num))
    return worst


def local_counts_vs_k2(net, ids, n_ids, device, n_dev=K20_SHARDS):
    """``mega_local_counts``, K20's package entry, on each of *n_dev*
    shards of one spike list of *net* (as bool spikes): the shards'
    float32 partials summed bitwise K2's counts. Returns K20's launches,
    one a shard."""
    import brainevent_torch as bt
    from brainevent_torch.ops import scatter as sc
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
    launches = bt.launch_counts()['mega_counts']
    check(launches == n_dev, ('mega_local_counts launches', launches))
    check(torch.equal(total, k2.float()), ('mega_local_counts vs K2', num))
    return launches


def indegree_net(device):
    """A 4k network whose target 17 has an in-degree of 300 from each
    class (the case the JAX mega-kernel refuses above 255)."""
    import brainevent_torch as bt
    rng = np.random.default_rng(290)
    conn = rng.integers(0, 4000, (4000, 80)).astype(np.int32)
    conn[:300, 0] = 17
    conn[3200:3500, 0] = 17
    return bt.EINet(scale=1.0, conn_all=conn, device=device)


def check_k20(device):
    phase(f'29 K20 mega_counts vs its twin and K2: COBA 4k and 400k spike '
          f'lists recorded from runs, split over {K20_SHARDS} shards '
          f'(row0 = r * n_loc): each partial bitwise its twin, the sum and '
          f'the shard-major buffer bitwise K2; an in-degree of 300 per '
          f'class, exact; at world size 1 bitwise its twin, and device ms '
          f'per launch')
    import brainevent_torch as bt
    from brainevent_torch.parallel import mega
    worst, res = 0.0, {}
    for label, scale in SHARD_NETS:
        net = bt.EINet(scale=scale, device=device)
        final = bt.einet_pallas_sim(net, net.init_state(), DENSE_TIME_WARM)
        ids, n_ids = recorded_spikes(net, final, DENSE_TIME_WARM, device)
        n_act = int(n_ids)
        worst = max(worst, k20_vs_k2(net, ids, n_ids, device))
        local_launches = local_counts_vs_k2(net, ids, n_ids, device)
        num, n_conn = net.num, net.conn_all.shape[1]
        # the main path's shape: world size 1, one shard of num neurons
        counts = torch.zeros(1, 2, num, dtype=torch.int32, device=device)
        args = (ids, n_ids, net.conn_all, 0, net.n_exc, counts)
        want = mega.mega_counts_twin(*args[:5], torch.zeros_like(counts))
        mega.mega_counts(*args)
        torch.cuda.synchronize()
        worst = max(worst, float((counts - want).abs().max()))
        check(torch.equal(counts, want), ('K20 vs twin at world size 1',
                                          num))
        reps, reps_twin = (500, 100) if num < 40_000 else (200, 20)
        ms = device_ms(lambda: mega.mega_counts(*args), reps)
        twin_ms = host_ms(lambda: mega.mega_counts_twin(*args), reps_twin)
        src = ids[:n_act].long()
        tgt = (net.conn_all[src].long() + num * (src >= net.n_exc).long()[
            :, None]).reshape(-1)
        ones = torch.ones(tgt.numel(), dtype=torch.int32, device=device)
        flat = torch.zeros(2 * num, dtype=torch.int32, device=device)
        lib_ms = device_ms(lambda: flat.index_add_(0, tgt, ones), reps)
        n_bytes = count_scatter_bytes(n_act, n_conn)
        res[label] = dict(ms=ms, plain_ms=twin_ms, library_ms=lib_ms,
                          bytes=n_bytes, n_act=n_act,
                          local_launches=local_launches)
        print(f'{label} ({n_act} spikes of {num}): {K20_SHARDS} shards '
              f'bitwise their twins, summed bitwise K2; mega_local_counts '
              f'on the {K20_SHARDS} shards ({local_launches} K20 launches) '
              f'summed bitwise K2; K20 device {ms!r} ms, twin {twin_ms!r} '
              f'ms, index_add_ {lib_ms!r} ms, bound {bound(n_bytes, 0)!r}')
        del net, final
    net = indegree_net(device)
    ids = torch.arange(net.num, dtype=torch.int32, device=device)
    n_ids = torch.tensor([net.num], dtype=torch.int32, device=device)
    worst = max(worst, k20_vs_k2(net, ids, n_ids, device))
    counts = mega.mega_counts(ids, n_ids, net.conn_all, 0, net.n_exc,
                              torch.zeros(1, 2, net.num, dtype=torch.int32,
                                          device=device))
    deg = torch.stack([torch.bincount(net.conn_all[:3200].reshape(-1).long(),
                                      minlength=4000),
                       torch.bincount(net.conn_all[3200:].reshape(-1).long(),
                                      minlength=4000)]).to(torch.int32)
    check(torch.equal(counts[0], deg) and int(deg[:, 17].min()) >= 300,
          ('K20 in-degree', deg[:, 17].tolist()))
    print(f'in-degree {deg[:, 17].tolist()} at target 17 (every neuron '
          f'spiking): exact, bitwise K2 over {K20_SHARDS} shards')
    return worst, res


SHARD_FLAGS = ((0, 0, 1), (1, 1, 1), (0, 1, 1), (1, 1, 0))  # parity, fold, step


def shard_buffers(net, n_dev, r, seed, device):
    """Shard *r* of *n_dev* of a random step state of *net*
    (:func:`random_step_state`): its ``n_loc`` neurons' K1 buffers, its
    rows of conn and the row parameters ``(p, row0)``."""
    bufs, t = random_step_state(net.num, seed, device)
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
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
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
            fields = ('v', 't_last', 'g_e', 'g_i', 'counts', 'spike_count')
            mega.einet_shard_step(*(kb[n] for n in fields), kp, conn, row0,
                                  net.n_exc, p, t, parity, fold, step)
            mega.einet_shard_step_twin(*(tb[n] for n in fields), tp, conn,
                                       row0, net.n_exc, p, t, parity, fold,
                                       step)
            torch.cuda.synchronize()
            for n in ('v', 't_last', 'g_e', 'g_i', 'spike_count'):
                worst = max(worst, float((kb[n] - tb[n]).abs().max()))
                check(torch.equal(kb[n], tb[n]), ('K22 vs twin', num, r, n))
                check(torch.equal(kb[n], k1[n]), ('K22 vs K1', num, r, n))
            check(torch.equal(kb['counts'], loc['counts'])
                  and torch.equal(tb['counts'], loc['counts']),
                  ('K22 leaves the counts', num, r))
            check(torch.equal(kp, tp), ('K22 partials vs twin', num, r))
            if step:
                check(torch.equal(kp[parity], full)
                      and int(kp[parity ^ 1].abs().sum()) == 0,
                      ('K22 partials vs K20', num, r, parity))
                total += kp[parity]
            else:
                check(bool((kp[parity ^ 1] == 5).all()),
                      ('a fold alone leaves the partials', num, r))
        if step:
            bufs, t = random_step_state(num, seed + k, device)
            p = net.step_params()
            nw.einet_step(*(bufs[n] for n in ORDER), p, t, parity, fold, step)
            k2 = sc.event_count_scatter(
                bufs['ids'], bufs['n_ids'][parity:parity + 1], net.conn_all,
                net.n_exc, torch.zeros(2, num, dtype=torch.int32,
                                       device=device))
            torch.cuda.synchronize()
            check(torch.equal(total.transpose(0, 1).reshape(2, num), k2),
                  ('K22 shards summed vs K2', num, n_dev))
    return worst


def k22_bytes(n_loc, num, n_act, n_conn):
    """The bytes one K22 step must move: v, t_last, g_e, g_i and two
    counts read and v, g_e, g_i written a neuron, t_last and spike_count
    of each spike, its row of conn, and the partials written once: the
    zeroing of the other parity's ``2 * num`` counts. The atomics of the
    hits add into partials that the zeroing left in L2 (3.2 MB at 400k),
    so they move no bytes of their own to HBM."""
    return 36 * n_loc + 8 * n_act + 4 * n_act * n_conn + 8 * num


def time_shard_step(net, final, steps_done, device):
    """K22's device ms per launch at world size 1 (``n_loc = num``) from a
    run's final state, queued back to back (fold and step, the parity
    alternating), beside the parent's K1 + memset + K20 for the same
    step, and K22's twin's ms; the bytes of the step it took."""
    from brainevent_torch.models import networks as nw
    from brainevent_torch.parallel import mega
    num, n_conn = net.num, net.conn_all.shape[1]
    p = net.step_params()
    b = [x.clone() for x in final[:4]]
    counts = torch.zeros(2, num, dtype=torch.int32, device=device)
    spike_count = final[4].clone()
    partials = torch.zeros(2, 1, 2, num, dtype=torch.int32, device=device)
    clock = [steps_done]

    def k22(op):
        t = float(F32(clock[0]) * F32(net.dt))
        op(*b, counts, spike_count, partials, net.conn_all, 0, net.n_exc, p,
           t, clock[0] & 1, True, True)
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
        t = float(F32(k) * F32(net.dt))
        nw.einet_step(*k1b, p, t, k & 1, True, True)
        full.zero_()
        mega.mega_counts(k1b[6], k1b[7][k & 1:(k & 1) + 1], net.conn_all, 0,
                         net.n_exc, full)
        clock[0] += 1

    # three launches a call: a quarter of the calls keeps the queue behind
    # the sleep kernel within the device's pending-launch limit
    parent_ms = device_ms(parent, reps // 4)
    return dict(ms=ms, plain_ms=twin_ms, parent_ms=parent_ms, n_act=n_act,
                bytes=k22_bytes(num, num, n_act, n_conn))


def check_k22(device):
    phase(f'29b K22 einet_shard_step vs its twin and vs one K1 step, a '
          f'memset and K20: random step states at COBA 4k and 400k, at world '
          f'size 1 and over {K20_SHARDS} shards (row0 = r * n_loc), each '
          f'parity, fold and step: all state and both parities of the '
          f'partials bitwise, the shards summed bitwise K2; device ms per '
          f'launch at world size 1 beside K1 + memset + K20')
    import brainevent_torch as bt
    worst, res = 0.0, {}
    for label, scale in SHARD_NETS:
        net = bt.EINet(scale=scale, device=device)
        for n_dev in (1, K20_SHARDS):
            worst = max(worst, k22_vs_k1_k20(net, device, n_dev, seed=29))
        final = bt.einet_pallas_sim(net, net.init_state(), DENSE_TIME_WARM)
        t = time_shard_step(net, final, DENSE_TIME_WARM, device)
        res[label] = t
        print(f'{label}: K22 bitwise its twin and K1 + memset + K20 at world '
              f'size 1 and over {K20_SHARDS} shards; a step ({t["n_act"]} '
              f'spikes of {net.num}): K22 device {t["ms"]!r} ms, K1 + memset '
              f'+ K20 {t["parent_ms"]!r} ms, twin {t["plain_ms"]!r} ms, '
              f'bound {bound(t["bytes"], 0)!r}')
        del net, final
    return worst, res


def sharded_net(net, mesh, propagate):
    """:class:`ShardedEINet` of *net* on *mesh* by *propagate*."""
    from brainevent_torch.parallel import ShardedEINet
    s = ShardedEINet.from_einet(net, mesh)
    return s if propagate == 'scatter' else dataclasses.replace(
        s, propagate=propagate)


def sharded_run(snet, state, n_steps, inp=20.0):
    """*n_steps* of *snet* from *state* with the launches and the
    collectives counted: ``(final, launch counts, collective calls)``."""
    import brainevent_torch as bt
    bt.reset_launch_counts()
    with collective_log() as calls:
        out = snet.run(n_steps, inp, state=state)
        torch.cuda.synchronize()
    return out, bt.launch_counts(), calls


def parent_sharded_run(snet, state, n_steps, inp=20.0):
    """The route K22 replaced, on this rank: :func:`einet_loop` over K1
    and, a step, a memset of the ``(n_dev, 2, n_loc)`` partials, K20 and
    one ``reduce_scatter_tensor``, composed here from the package's parts
    (three launches and a collective a step). Returns the five local
    arrays."""
    import torch.distributed as dist
    from brainevent_torch.models.networks import einet_loop
    from brainevent_torch.parallel import mega
    full = torch.empty(snet.n_dev, 2, snet.n_loc, dtype=torch.int32,
                       device=snet.device)

    def propagate(ids, n_ids, counts):
        full.zero_()
        mega.mega_counts(ids, n_ids, snet.indices_loc, snet.row0,
                         snet.n_exc, full)
        dist.reduce_scatter_tensor(counts.view(-1), full.view(-1),
                                   group=snet._axis.group)
    return einet_loop(*(x.to_local() for x in state),
                      snet.times(n_steps), snet.step_params(inp), propagate)


def check_sharded_einet(mesh, device):
    phase(f'30 ShardedEINet on the card (world size 1, NCCL), COBA 4k and '
          f'400k, propagate scatter and mxu6: {SHARD_STEPS} steps, all five '
          f'fields bitwise EINet; K22 {SHARD_STEPS + 1} launches, K1 and K20 '
          f'none; one reduce-scatter of 2 * num * 4 bytes per step and no '
          f'other collective; the parent\'s route (K1 + memset + K20) '
          f'bitwise too; us/step over {SHARD_TIME_STEPS} steps after '
          f'{SHARD_TIME_WARM}, K22 and the parent\'s route in turns, beside '
          f'EINet')
    import brainevent_torch as bt
    res = {}
    for label, scale in SHARD_NETS:
        net = bt.EINet(scale=scale, coba=True, device=device)
        state = net.init_state()
        ref = net.run(SHARD_STEPS, state=state)
        want = (ref.neurons.v, ref.neurons.t_last, ref.g_e, ref.g_i,
                ref.spike_count)
        for propagate in ('scatter', 'mxu6'):
            snet = sharded_net(net, mesh, propagate)
            s0 = snet.init_state_from(state)
            out, counts, calls = sharded_run(snet, s0, SHARD_STEPS)
            for x, y in zip(out, want):
                check(x.to_local().dtype == y.dtype
                      and torch.equal(x.to_local(), y),
                      (label, propagate, 'bitwise EINet'))
            check(counts['einet_shard_step'] == SHARD_STEPS + 1
                  and counts['einet_step'] == 0
                  and counts['mega_counts'] == 0
                  and counts['event_scatter_float'] == 0
                  and counts['event_count_scatter'] == 0,
                  (label, propagate, counts))
            check([c for c, _ in calls] == ['reduce_scatter_tensor']
                  * SHARD_STEPS and {b for _, b in calls} == {
                      2 * net.num * 4}, (label, propagate, calls[:3]))
            res[label, propagate] = dict(counts=counts)
            print(f'COBA {label} {propagate}: bitwise EINet on all five '
                  f'fields over {SHARD_STEPS} steps '
                  f'({int(ref.spike_count.sum())} spikes); launches '
                  f'{counts["einet_shard_step"]} K22, {counts["einet_step"]} '
                  f'K1, {counts["mega_counts"]} K20; {len(calls)} '
                  f'reduce-scatters of {2 * net.num * 4} bytes, no other '
                  f'collective')
        # the parent's route, its launches counted (K20's path)
        snet = sharded_net(net, mesh, 'mxu6')
        bt.reset_launch_counts()
        with collective_log() as calls:
            out = parent_sharded_run(snet, snet.init_state_from(state),
                                     SHARD_STEPS)
            torch.cuda.synchronize()
        counts = bt.launch_counts()
        check_equal_fields(out, want, (label, 'parent route'))
        check(counts['einet_step'] == SHARD_STEPS + 1
              and counts['mega_counts'] == SHARD_STEPS
              and counts['einet_shard_step'] == 0
              and len(calls) == SHARD_STEPS, (label, 'parent', counts))
        res[label, 'parent'] = dict(counts=counts)
        # timing: EINet, then K22 and the parent's route in turns
        us = {'EINet': [], 'K22': [], 'K1 + memset + K20': []}
        s_warm = snet.run(SHARD_TIME_WARM, state=snet.init_state_from(state))
        warm = net.run(SHARD_TIME_WARM, state=state)
        for route in ('EINet', 'K22', 'K1 + memset + K20',
                      'K1 + memset + K20', 'K22', 'EINet'):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == 'EINet':
                net.run(SHARD_TIME_STEPS, state=warm)
            elif route == 'K22':
                snet.run(SHARD_TIME_STEPS, state=s_warm)
            else:
                parent_sharded_run(snet, s_warm, SHARD_TIME_STEPS)
            torch.cuda.synchronize()
            us[route].append((time.perf_counter() - t0) / SHARD_TIME_STEPS
                             * 1e6)
        # the step's one collective alone, on the step's buffers
        import torch.distributed as dist
        full = torch.zeros(1, 2, net.num, dtype=torch.int32, device=device)
        counts = torch.empty(2, net.num, dtype=torch.int32, device=device)
        us['reduce_scatter'] = host_ms(
            lambda: dist.reduce_scatter_tensor(counts.view(-1),
                                               full.view(-1)),
            SHARD_TIME_STEPS) * 1e3
        res[label, 'us'] = us
        print(f'COBA {label} us/step over {SHARD_TIME_STEPS} steps after '
              f'{SHARD_TIME_WARM} (host clock): EINet {us["EINet"]!r}, '
              f'sharded K22 {us["K22"]!r}, the parent\'s K1 + memset + K20 '
              f'{us["K1 + memset + K20"]!r} (in turns); the reduce-scatter '
              f'alone {us["reduce_scatter"]!r} us per call')
        del net, ref, want
    return res


def check_sharded_ops(mesh, device):
    phase('31 the sharded ops on the card (world size 1): '
          'sharded_binary_fcnmv (homogeneous and heterogeneous, both '
          'directions, psum and psum_scatter), the four CSR wrappers both '
          'ways, a CSR weight gradient, bitwise the single-device entries '
          '(the float atomics of K5 and K8 within 1e-5 * sum|w x|); K11 and '
          'K12 at the 80k E projection in two halves (row0 0 and n/2): '
          'gather and plans bitwise the whole walk, scatter within 1e-5 * '
          'sum|w x|')
    import brainevent_torch as bt
    from brainevent_torch import parallel as par
    from brainevent_torch.jitc import pallas_kernels as jk
    from brainevent_torch._misc import _initialize_conn_length
    gen = torch.Generator(device=device).manual_seed(31)
    n, m, k = SHARD_OPS_N, SHARD_OPS_N, 80
    idx = torch.randint(0, m, (n, k), generator=gen, device=device,
                        dtype=torch.int32)
    w_ell = torch.randn(n, k, generator=gen, device=device)
    spk = {True: torch.rand(n, generator=gen, device=device) < 0.01,
           False: torch.rand(m, generator=gen, device=device) < 0.01}
    n_case = 0
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
                torch.cuda.synchronize()
                if transpose and not homo:          # K5's float atomics
                    within(got, want, bt.binary_fcnmv(
                        w.abs(), idx, s, shape=(n, m), transpose=True),
                        ('sharded fcn', homo, transpose, reduce))
                else:
                    check(torch.equal(got, want),
                          ('sharded fcn', homo, transpose, reduce))
                n_case += 1
    cm, ck = SHARD_CSR
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
            torch.cuda.synchronize()
            if transpose and got.dim() == 1:        # K8's float atomics
                within(got, want, single(A.data.abs(), *args, o.abs() if
                                         o.is_floating_point() else o,
                                         shape=shape, transpose=True),
                       (name, transpose))
            else:
                check(torch.equal(got, want), (name, transpose))
            n_case += 1
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
    torch.cuda.synchronize()
    check(torch.equal(*grads), 'sharded CSR weight gradient (K9)')
    n_case += 1
    print(f'{n_case} sharded op cases equal to the single-device entries '
          f'(K5-K10 through the sharded wrappers)')
    # K11 and K12 with row0 at the 80k E projection of JITCNet(scale=20)
    n_rows, n_cols = SHARD_JITC
    kw = dict(law=1, a=0.6, b=float(F32(0.06)), seed=42,
              cl=_initialize_conn_length(80 / n_cols), logical_cols=n_cols)
    chunk = -(-n_cols // 4)
    half = n_rows // 2
    s_all, q_all, _ = jk.walk_plan_setup(42, kw['cl'], n_rows, n_cols, chunk,
                                         device=device)
    halves = [jk.walk_plan_setup(42, kw['cl'], half, n_cols, chunk,
                                 device=device, row0=r0)
              for r0 in (0, half)]
    torch.cuda.synchronize()
    check(torch.equal(torch.cat([h[0] for h in halves]), s_all)
          and torch.equal(torch.cat([h[1] for h in halves]), q_all),
          'K11 row0 halves bitwise the whole plan')
    v = torch.randn(n_cols, generator=gen, device=device)
    whole = jk.jitc_walk_mv(None, None, v, n_rows=n_rows, n_cols=n_cols,
                            corder=True, event=False, **kw)
    for plan_h in ((None, None), None):
        parts = [jk.jitc_walk_mv(*(plan_h or halves[i][:2]), v,
                                 n_rows=half, n_cols=n_cols, corder=True,
                                 event=False, row0=i * half, **kw)
                 for i in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(torch.cat(parts), whole),
              ('K12 row0 gather', plan_h is None))
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
    err = within(parts, whole, visits * (0.6 + 6 * 0.06), 'K12 row0 scatter')
    got = par.sharded_jitmv('n', (0.6, 0.06), 80 / n_cols, v, 42, mesh=mesh,
                            shape=(n_rows, n_cols)).to_local()
    want = bt.jitnmv(0.6, 0.06, 80 / n_cols, v, 42, shape=(n_rows, n_cols))
    torch.cuda.synchronize()
    check(torch.equal(got, want), 'sharded_jitmv bitwise jitnmv')
    print(f'K11/K12 row0 at ({n_rows}, {n_cols}): plan halves and gathers '
          f'bitwise the whole walk; scatter halves within {err!r} '
          f'(1e-5 * sum|w x|); sharded_jitmv bitwise jitnmv')


def neuron_mesh_world1(device):
    """The process group of this one process (NCCL on the card, through a
    file store in a temporary directory: no TCP port) and a 1-D neuron
    mesh over it."""
    import tempfile
    import torch.distributed as dist
    from brainevent_torch.parallel import neuron_mesh
    store = tempfile.mkdtemp(prefix='chip_smoke_pg_')
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            init_method=f'file://{store}/pg', rank=0,
                            world_size=1)
    return neuron_mesh(1, device_type=device.type)


TREE_PARTS = ('k10', 'jitc', 'k15', 'train', 'dense', 'ei', 'ei_dense')


def time_tree(tree, parts=TREE_PARTS):
    """``--tree DIR``: time DIR's ``brainevent_torch`` by this file's code,
    on the inputs of the phases, so that two checkouts are timed by the
    same code: run it for each in turns (A, B, B, A). *parts*:

    - ``k10``: phase 17's ``time_k10`` (the CSR pattern, the csrmm cell and
      its plan);
    - ``jitc``: phase 20's ``JITCNet`` steps, ``time_plan_routes`` and
      profiled steps (the 4k and 80k nets after JITC_STEPS and the spikes
      of step JITC_STEPS + 1100);
    - ``k15``: phase 24's ``time_k15`` at (10k, 10k, 1%), both ways;
    - ``train``: phase 10's timed and profiled train steps of the 100k x
      100 model (``train_step_times``), through the tree's own
      ``train_step``;
    - ``dense``: phase 23's dense slice from phase 21's weights, 20 steps
      on the host clock and 10 profiled (``dense_slice_times``);
    - ``ei``: phase 6's COBA runs through ``einet_pallas_sim`` at
      :data:`EI_TIMES` (``time_run``, twice each), so a design variant of
      the EI route can be timed beside this tree's;
    - ``ei_dense``: phase 27's COBA runs of the dense strategy at
      :data:`DENSE_TIMES` (``time_run``, twice each, bitwise mxu3) and its
      one launch's device us/step over EI_STEPS steps on from there.

    Prints one JSON line."""
    import os
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    device_info()
    device = torch.device('cuda:0')
    import brainevent_torch as bt
    from brainevent_torch.ops import cuda_build
    check(os.path.dirname(os.path.dirname(os.path.abspath(bt.__file__)))
          == tree, ('brainevent_torch not from', tree, bt.__file__))
    cuda_build.library()
    print(f'brainevent_torch of {tree}: nvcc '
          f'{cuda_build.last_build_seconds()!r} s')
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
        slice_out = {}
        for label, scale in JITC_SCALES.items():
            net = bt.JITCNet(scale=scale, weight_law='normal', coba=True,
                             device=device)
            final, _ = jitc_run(net, net.init_state(), JITC_STEPS)
            slice_out[label] = dict(net=net, final=final)
        time_jitc_steps(slice_out)
        o = slice_out['80k']
        net, state = o['net'], o['last_state']
        spk = recorded_jitc_spikes(net, state)[1][:net.n_exc].contiguous()
        res['k12'] = time_plan_routes(net, spk, k12_kwargs(net), device)
        res['jitcnet_us_per_step'] = {k: o['us_timed']
                                      for k, o in slice_out.items()}
        res['jitcnet_80k_kernel_us_per_step'] = profile_jitc(net, state)
        del slice_out, net, state
    if 'k15' in parts:
        gen = torch.Generator(device=device).manual_seed(24)
        W = torch.randn(DENSE_N, DENSE_N, generator=gen, device=device)
        s = torch.rand(DENSE_N, generator=gen, device=device) < DENSE_RATE
        res['k15'] = {k: {f: r[f] for f in ('ms', 'library_ms')}
                      for k, r in time_k15(W, s).items()}
        del W
    if 'train' in parts:
        model = bt.SurrogateSNN(**BIG, seed=2, device=device)
        x = torch.rand(50, 100, generator=torch.Generator(
            device='cpu').manual_seed(10)).to(device)
        p, _ = bt.train_step(model, model.init_params(), x, 3, lr=1e-3)
        t = train_step_times(model, p, x)
        print(f'train step: {t!r}')
        res['train'] = t
        del model
    if 'dense' in parts:
        gen = torch.Generator(device=device).manual_seed(210)
        W = bt.Dense(torch.randn(DENSE_N, DENSE_N, generator=gen,
                                 device=device))
        dense_step_loop(W, 5, device)
        t = dense_slice_times(W, device, 20)
        print(f'dense slice: {t!r}')
        res['dense'] = t
    if 'ei' in parts:
        res['ei'] = {}
        for label, n_steps, warm in EI_TIMES:
            net = bt.EINet(scale=1.0 if label == '4k' else 100.0,
                           device=device)
            runs = [time_run(net, n_steps, warm) for _ in range(2)]
            res['ei'][label] = [us for us, _, _ in runs]
            print(f'COBA {label}: {res["ei"][label]!r} us/step over {n_steps} '
                  f'steps after {warm} (host clock)')
    if 'ei_dense' in parts:
        from brainevent_torch.models import sim
        res['ei_dense'] = {}
        for label, scale, n_steps, warm in DENSE_TIMES:
            net = bt.EINet(scale=scale, device=device)
            runs = [time_run(net, n_steps, warm, 'dense') for _ in range(2)]
            out = runs[-1][2]
            check_equal_fields(out, time_run(net, n_steps, warm, 'mxu3')[2],
                               ('dense bitwise mxu3', label))
            final = bt.EINetState(bt.LIFRefState(*out[:2]), *out[2:])
            ms, _ = sim_device_ms(net, final, EI_STEPS, n_steps,
                                  table=sim.dense_count_table(net))
            res['ei_dense'][label] = dict(
                us=[us for us, _, _ in runs],
                device_us=ms / EI_STEPS * 1e3)
            print(f'COBA {label} dense: {res["ei_dense"][label]!r} (us/step '
                  f'over {n_steps} steps after {warm}, host clock; device '
                  f'us/step of one launch over {EI_STEPS} steps)')
    print(json.dumps(res))
    return 0


def main():
    import argparse
    ap = argparse.ArgumentParser(description='Smoke test of brainevent_torch '
                                 'on one NVIDIA GPU.')
    ap.add_argument('--tree', help='only time this checkout\'s '
                    'brainevent_torch (see time_tree)')
    ap.add_argument('--parts', default=','.join(TREE_PARTS),
                    help='with --tree, the comma-separated parts to time, '
                    f'of {",".join(TREE_PARTS)} (default: all)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 2
    if args.tree:
        parts = args.parts.split(',')
        check(set(parts) <= set(TREE_PARTS), ('--parts', parts))
        return time_tree(args.tree, parts)
    kind = device_info()
    device = torch.device('cuda:0')

    import brainevent_torch as bt
    from brainevent_torch.ops import cuda_build
    phase('2 build')
    t0 = time.perf_counter()
    cuda_build.library()
    print(f'kernel library ready in {time.perf_counter() - t0!r} s '
          f'(nvcc {cuda_build.last_build_seconds()!r} s) under '
          f'{cuda_build.build_dir()}')

    t0 = time.perf_counter()
    nets = {'4k': bt.EINet(scale=1.0, coba=True, device=device),
            '400k': bt.EINet(scale=100.0, coba=True, device=device)}
    torch.cuda.synchronize()
    print(f'networks built in {time.perf_counter() - t0!r} s '
          f'(400k conn_all {nets["400k"].conn_all.numel() * 4 / 2**20!r} MiB '
          f'on the device)')

    k1_err = check_k1(nets, device)
    k2_err = check_k2(nets, device)
    launches, big_counts = check_slice(device)

    phase('6 timing')
    ei_times, finals = time_ei(nets, device)
    times = time_kernels(nets, finals, device)
    times['k21'] = time_k21(nets['4k'], ei_times['4k']['final'],
                            ei_times['4k'], device)
    del nets, finals

    t0 = time.perf_counter()
    model = bt.SurrogateSNN(**BIG, seed=2, device=device)
    torch.cuda.synchronize()
    print(f'100k x 100 model built in {time.perf_counter() - t0!r} s')
    plan_err = check_plans(model, device)
    fcn_err = check_fcn(device)
    runs, fcn_counts = drive_fcnmv(device)
    check_training_small(device)
    plan_counts, event_counts, _ = check_training_full(model, device)
    check_learning(device)
    new_times = time_new_kernels(model, runs, device)
    del model

    t0 = time.perf_counter()
    W = random_csr(CSR_N, CSR_DENSITY, 130, device)
    torch.cuda.synchronize()
    print(f'{CSR_N} x {CSR_N} CSR at {CSR_DENSITY:.0%} built in '
          f'{time.perf_counter() - t0!r} s: {W.nse} entries')
    csr_err = check_csr_event(W, device)
    csr_err['pair_gather'] = check_pair_gather(W, device)
    A, plan, w_sorted, csr_err['csr_gather_mm'], _ = check_csr_mm(
        W, device)
    csr_counts, W = check_csr_slice(W, device)
    csr_times = time_csr_kernels(W, A, plan, w_sorted, device)

    jitc_err, jitc_plans, jitc_visits, jitc_clen = check_jitc_kernels(device)
    surface_counts = drive_jitc_surface(device)
    jitc_slice = check_jitc_slice(device)
    jitc_times = time_jitc(jitc_slice, jitc_plans, jitc_visits, jitc_clen,
                           device)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(210)
    W0 = torch.randn(DENSE_N, DENSE_N, generator=gen, device=device)
    torch.cuda.synchronize()
    print(f'{DENSE_N} x {DENSE_N} dense weights built in '
          f'{time.perf_counter() - t0!r} s')
    dense_err = check_dense_products(W0, device)
    dense_err['dense_stdp_pre'] = dense_err['dense_stdp_post'] = \
        dense_err['event_row_count'] = check_dense_stdp_and_encoders(
            W0, device)
    dense_counts, _, W_end = check_dense_slice(W0, device)
    del W0
    dense_times = time_dense_kernels(W_end.data, device)
    del W_end

    k19_err = check_k19(device)
    sim_launches, dense_launches = check_dense_strategies(device)
    sim_times = time_dense(device)
    check_c8(device)

    k20_err, k20_times = check_k20(device)
    k22_err, k22_times = check_k22(device)
    mesh = neuron_mesh_world1(device)
    shard_res = check_sharded_einet(mesh, device)
    check_sharded_ops(mesh, device)
    torch.distributed.destroy_process_group()

    from brainevent_torch.ops.core import REGISTRY

    def entry(op_name, launches, err, t):
        op = REGISTRY[op_name]
        bound_ms, bound_by = bound(t['bytes'], t.get('ops', 0))
        return {'name': op_name, 'route': 'cuda', 'source': op.source,
                'replaces': op.replaces, 'launches': launches,
                'max_abs_err': err, 'ms': t['ms'], 'plain_ms': t['plain_ms'],
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'library_ms': t.get('library_ms'),
                **({'by_shape': t['by_shape']} if 'by_shape' in t else {})}

    t4k = times['4k']
    # K1 and K2 on their route by size (above K21's capacity), K21 on the
    # main path
    kernels = [
        entry('einet_step', big_counts['einet_step'], k1_err, dict(
            ms=t4k['k1_ms'], plain_ms=t4k['k1_twin_ms'],
            bytes=t4k['k1_bytes'], ops=20 * 4000)),
        entry('event_count_scatter', big_counts['event_count_scatter'],
              k2_err, dict(ms=t4k['k2_ms'], plain_ms=t4k['k2_twin_ms'],
                           bytes=t4k['k2_bytes'],
                           library_ms=t4k['k2_library_ms'])),
        entry('einet_sim', launches['einet_sim'], times['k21']['err'],
              times['k21'])]
    errs = {**plan_err, **fcn_err}
    for op_name, counts in (('plan_gather_mv', plan_counts),
                            ('plan_matvec_dw', plan_counts),
                            ('fcn_event_scatter', event_counts),
                            ('fcn_event_gather', fcn_counts)):
        kernels.append(entry(op_name, counts[op_name], errs[op_name],
                             new_times[op_name]))
    for op_name in CSR_OPS:
        kernels.append(entry(op_name, csr_counts[op_name], csr_err[op_name],
                             csr_times[op_name]))
    o80 = jitc_slice['80k']
    for op_name, counts in (('jitc_walk_setup', o80['setup_counts']),
                            ('jitc_walk_mv', o80['counts']),
                            ('jitc_walk_mm', surface_counts),
                            ('jitc_walk_mm4', surface_counts),
                            ('jitc_walk_todense', surface_counts),
                            ('jitc_walk_todense4', surface_counts)):
        kernels.append(entry(op_name, counts[op_name], jitc_err[op_name],
                             jitc_times[op_name]))
    for op_name in DENSE_OPS:
        kernels.append(entry(op_name, dense_counts[op_name],
                             dense_err[op_name], dense_times[op_name]))
    # K21's table instance and K22 on the dense strategy's and the sharded
    # network's paths; K19 and K20 left them, and stay as the parent
    # routes' yardsticks: K19's launches are the parent's dense route's
    # (phase 26, the route the package keeps above the table capacity),
    # K20's those of its package entry, mega_local_counts (phase 29)
    kernels.append(dict(
        entry('einet_dense_hits', sim_launches['einet_dense_hits'], k19_err,
              sim_times['4k']),
        yardstick='the parent dense route, K1 + K19 (dense_k19)'))
    kernels.append(dict(
        entry('mega_counts', k20_times['400k']['local_launches'], k20_err,
              k20_times['400k']),
        yardstick='the parent sharded step, K1 + memset + K20; launches '
                  'from mega_local_counts'))
    table = entry('einet_sim', dense_launches['einet_sim'],
                  sim_times['table']['err'], sim_times['table'])
    kernels.append(dict(table, name='einet_sim_table',
                        replaces='brainevent_tpu/models/pallas_sim.py:532'))
    kernels.append(entry('einet_shard_step',
                         shard_res['400k', 'mxu6']['counts'][
                             'einet_shard_step'], k22_err, k22_times['400k']))
    for k in kernels:
        check(k['launches'] > 0, (k['name'], 'not launched on its path'))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
