# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Smoke test of brainevent_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``brainevent_torch/csrc`` and drives the
port's main path, the COBA EI network (Brette et al. 2007) at 4,000
neurons, through ``einet_pallas_sim``. Phases:

1. the device (``torch.cuda.get_device_name`` and ``nvidia-smi``);
2. the kernel build, with its seconds;
3. K1 (``einet_step``) against its PyTorch twin on the card, on random
   states across the refractory boundary, COBA and CUBA, 4k and 400k
   neurons: bitwise equal;
4. K2 (``event_count_scatter``, and its float form) against its twin on
   random spike lists, up to every neuron spiking at once: equal;
5. the slice: COBA and CUBA at 4k for 2,000 steps through the kernels,
   against the twin loop on the same card and inputs: equal spike counts;
   K1 launched once per step (plus one final fold) and K2 once per step;
   firing rate within 5-200 Hz;
6. timing, for the record: 4k COBA over 100k steps and 400k COBA over
   5,000 steps in us/step (host clock); each kernel's device time (CUDA
   events around launches queued back to back), its host-paced time per
   launch, and its twin's time per call.

Any failure exits non-zero; so does a host without CUDA. The line before
the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

F32 = np.float32


def phase(name):
    print(f'== {name}', flush=True)


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


def check_slice(device):
    phase('5 the slice: einet_pallas_sim at 4k, 2000 steps (spike counts '
          'equal to the twin loop)')
    import brainevent_torch as bt
    from brainevent_torch.models import networks as nw
    from brainevent_torch.ops import scatter as sc
    n_steps = 2000
    launches = None
    for coba in (True, False):
        net = bt.EINet(scale=1.0, coba=coba, device=device)
        state = net.init_state()
        bt.reset_launch_counts()
        t0 = time.perf_counter()
        out = bt.einet_pallas_sim(net, state, n_steps)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        counts = bt.launch_counts()
        if coba:
            launches = counts
        check(counts['einet_step'] == n_steps + 1, counts)
        check(counts['event_count_scatter'] == n_steps, counts)
        t0 = time.perf_counter()
        ref = net._simulate(state, net.times(n_steps), 20.0,
                            step_op=nw.einet_step_twin,
                            scatter_op=sc.event_count_scatter_twin)
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t0
        v, t_last, g_e, g_i, spike_count = out
        for x in (v, t_last, g_e, g_i):
            check(x.shape == (net.num,) and bool(torch.isfinite(x).all()),
                  'finite (num,) state')
        check(spike_count.dtype == torch.int32, spike_count.dtype)
        check(torch.equal(spike_count, ref.spike_count), coba)
        dv = float((v - ref.neurons.v).abs().max())
        rate = float(spike_count.float().mean()) / (n_steps * net.dt * 1e-3)
        check(5.0 < rate < 200.0, rate)
        print(f'{"COBA" if coba else "CUBA"} 4k: spike counts equal '
              f'({int(spike_count.sum())} spikes), max|dv| {dv!r}, '
              f'rate {rate!r} Hz, launches {counts}, kernels '
              f'{t_kernel / n_steps * 1e6!r} us/step, twin loop '
              f'{t_twin / n_steps * 1e6!r} us/step (host clock)')
    return launches


def time_run(net, n_steps, warm):
    import brainevent_torch as bt
    state = bt.einet_pallas_sim(net, net.init_state(), warm)
    state = bt.EINetState(bt.LIFRefState(state[0], state[1]), *state[2:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bt.einet_pallas_sim(net, state, n_steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = float(out[4].float().mean()) / (n_steps * net.dt * 1e-3)
    return dt / n_steps * 1e6, rate, out


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
        out[label] = res
        print(f'{label} ({num} neurons), ms per call: K1 device '
              f'{res["k1_ms"]!r}, host-paced {res["k1_host_ms"]!r}, twin '
              f'{res["k1_twin_ms"]!r}; K2 ({n_events} spikes) device '
              f'{res["k2_ms"]!r}, host-paced {res["k2_host_ms"]!r}, twin '
              f'{res["k2_twin_ms"]!r}')
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 2
    name = device_info()
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
    launches = check_slice(device)

    phase('6 timing')
    finals = {}
    for label, n_steps, warm in (('4k', 100_000, 1000), ('400k', 5000, 200)):
        us, rate, final = time_run(nets[label], n_steps, warm)
        finals[label] = (warm + n_steps, final)
        print(f'COBA {label}: {us!r} us/step over {n_steps} steps after '
              f'{warm} warm-up steps, rate {rate!r} Hz')
    times = time_kernels(nets, finals, device)

    from brainevent_torch.models.networks import einet_step
    from brainevent_torch.ops.scatter import event_count_scatter
    kernels = []
    for op, err, key in ((einet_step, k1_err, 'k1'),
                         (event_count_scatter, k2_err, 'k2')):
        kernels.append({
            'name': op.name, 'route': 'cuda', 'source': op.source,
            'replaces': op.replaces, 'launches': launches[op.name],
            'max_abs_err': err, 'ms': times['4k'][f'{key}_ms'],
            'plain_ms': times['4k'][f'{key}_twin_ms']})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
