"""K24's step on the card, split into its parts: the step with its walk,
the update with the Poisson draw (and the barriers), the two grid barriers
alone, and the launch's flush; beside it, the clocked instance's own
phases of the same launch.

    python3 scripts/stdp_split.py [--model hpc] [--scale 10] [--steps 5000] \\
        [--warm 2000] [--seed 7] [--turns 3]

``--model istdp`` splits K24's iSTDP instance on Vogels et al. 2011's
network (``IstdpNet``, scale 20 by default) alike: it has no Poisson draw
and no flush (every update eager), so ``flush`` is the launch's fixed
cost, and its counters are the pre and post updates.

On a card, from the root of a checkout; prints one JSON line. It draws
NEST's HPC benchmark network at *scale* on the card
(``build_hpc_network``), runs ``--warm`` steps from a drawn state past the
start-up transient, then times in turns, by CUDA events around one K24
launch each (``stdp_sim`` on copies of the state, so not ``run``'s copy
of the weights), from that state:

- ``whole``: K24 over the network, ``--steps`` steps;
- ``clocked``: the same launch of K24's clocked instance (the one a traced
  ``run`` takes), whose warps time their update, walk, barriers and flush;
- ``half``: the same over half as many steps;
- ``no_rows``: K24 over the same neurons with every row empty: the same
  update, draw, traces and barriers, no walk and nothing to flush (the
  neurons, driven by the Poisson input alone, fire faster);
- ``barrier``: ``2 --steps`` grid barriers alone on K24's grid.

A launch is its steps and one flush, so ``step`` is ``(whole - half)``
over the steps between them, and ``flush`` (ms a launch) ``whole`` less
``--steps`` of them. ``update`` is ``no_rows - barrier`` and ``row_walk``
``step - no_rows``, in µs a step. ``phases_us`` is the clocked launches'
mean warp's time a step in each phase (their median), to compare with the
subtraction (the in-kernel barrier holds the wait for the slowest block,
which the subtraction puts in the walk), and ``clocked_cost_pct`` the
clocked launch's time over ``whole``'s. It also prints the populations'
rates over the first ``whole`` launch, its spikes, deliveries,
depressions and facilitations a step (the clocked instance's counters),
the share of the facilitations the flush made, K24's grid, the split
plan's bytes and the memory peak.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--model', choices=('hpc', 'istdp'), default='hpc')
    parser.add_argument('--scale', type=float, default=None)
    parser.add_argument('--steps', type=int, default=5000)
    parser.add_argument('--warm', type=int, default=2000)
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--turns', type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import brainevent_torch as bt
    from brainevent_torch.models import hpc_stdp as hs
    from brainevent_torch.ops import cuda_build
    from brainevent_torch.ops.core import cuda_stream

    device = torch.device('cuda')
    hpc = args.model == 'hpc'
    if hpc:
        m, entry, op, grid = hs, bt.HpcStdpNet, hs.stdp_sim, hs.stdp_sim_grid
        n_counts = hs.HPC_COUNTS
    else:
        from brainevent_torch.models import istdp_net as m
        entry, op, grid = bt.IstdpNet, m.istdp_sim, m.istdp_sim_grid
        n_counts = m.ISTDP_COUNTS
    scale = args.scale or (10.0 if hpc else 20.0)
    t0 = time.perf_counter()
    net = entry(scale=scale, seed=args.seed, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_rows = net.plastic_ptr.numel()
    empty = entry(
        scale=scale, device=device,
        targets=torch.zeros(0, dtype=torch.int32),
        plastic_ptr=torch.zeros(n_rows, dtype=torch.int32),
        static_ptr=torch.zeros(net.num + 1, dtype=torch.int32),
        weights=torch.zeros(0))
    state = net.run(args.warm, state=net.init_state(
        torch.Generator().manual_seed(args.seed + 1)))
    bare = state._replace(weights=empty.weights)
    blocks = grid(net.num, device)
    barriers = cuda_build.function('mc_sim_barriers_launch', [
        ctypes.c_int] * 3 + [ctypes.c_void_p])
    half = args.steps // 2

    def timed(fn):
        """fn's device ms between two CUDA events, and what it returns."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def launch(on, st, n_steps, counters=None):
        """One K24 launch of n_steps from st: its ms and its state."""
        out = [getattr(st, k).clone() for k in m.STATE_FIELDS]
        p = (on.step_params(st.key, st.step) if hpc
             else on.step_params(st.step))
        ms, _ = timed(lambda: op(
            *out, on.targets, on.plastic_ptr, on.static_ptr, n_steps, p,
            scratch=on.plan, counters=counters))
        return ms, dict(zip(m.STATE_FIELDS, out))

    def barrier():
        err = barriers(2 * args.steps, blocks, device.index or 0,
                       cuda_stream(device))
        if err:
            raise RuntimeError(f'mc_sim_barriers_launch: CUDA error {err}')

    ms = {'whole': [], 'clocked': [], 'half': [], 'no_rows': [],
          'barrier': []}
    first, counters = None, []
    for turn in range(args.turns):
        x, out = launch(net, state, args.steps)
        if turn == 0:
            first = out
        ms['whole'].append(x)
        counters.append(torch.zeros(n_counts, dtype=torch.int64,
                                    device=device))
        x, clocked = launch(net, state, args.steps, counters[-1])
        ms['clocked'].append(x)
        if not all(torch.equal(clocked[k], out[k]) for k in out):
            raise RuntimeError('the clocked instance differs from the plain '
                               'one')
        ms['half'].append(launch(net, state, half)[0])
        ms['no_rows'].append(launch(empty, bare, args.steps)[0])
        ms['barrier'].append(timed(barrier)[0])
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    step_us = (med['whole'] - med['half']) * 1e3 / (args.steps - half)
    no_rows_us = med['no_rows'] * 1e3 / args.steps
    barrier_us = med['barrier'] * 1e3 / args.steps
    updates = dict(zip((k.rsplit('.', 1)[1] for k in m.COUNTERS),
                       counters[0][:len(m.COUNTERS)].tolist()))
    warp_steps = blocks * hs.HPC_BLOCK // 32 * args.steps
    phases_us = {name: sorted(int(c[len(m.COUNTERS) + k]) for c in counters)[
        len(counters) // 2] / warp_steps * 1e-3
        for k, name in enumerate(m.PHASES)}
    spikes = (first['spike_count'] - state.spike_count).to(torch.int64)
    degree = (net.static_ptr[1:] - net.static_ptr[:-1]).to(torch.int64)
    plastic_rows = (net.plastic_ptr[1:] - net.plastic_ptr[:-1]).to(
        torch.int64)
    if hpc:
        degree[:net.n_exc] += plastic_rows
    else:
        degree[net.n_exc:] += plastic_rows
    seconds = args.steps * net.params.dt * 1e-3
    extra = (dict(depressions_per_step=updates['depressions'] / args.steps,
                  facilitations_per_step=updates['facilitations']
                  / args.steps,
                  flush_share=(updates['flush_facilitations']
                               / updates['facilitations']
                               if updates['facilitations'] else None))
             if hpc else
             dict(pre_updates_per_step=updates['pre_updates'] / args.steps,
                  post_updates_per_step=updates['post_updates']
                  / args.steps))
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device), nvidia_smi=power_limit(),
        torch=torch.__version__, cuda=torch.version.cuda, model=args.model,
        scale=scale, num=net.num, n_exc=net.n_exc,
        synapses=net.targets.numel(), plastic=net.n_plastic, blocks=blocks,
        npt=-(-net.num // (blocks * hs.HPC_BLOCK)), steps=args.steps,
        half=half, warm=args.warm, build_s=build_s,
        launch_ms=ms, us_per_step=dict(
            whole=med['whole'] * 1e3 / args.steps, step=step_us,
            no_rows=no_rows_us, barrier=barrier_us,
            clocked=med['clocked'] * 1e3 / args.steps),
        split_us=dict(update=no_rows_us - barrier_us,
                      row_walk=step_us - no_rows_us, barrier=barrier_us,
                      flush_amortized=(med['whole'] * 1e3
                                       - args.steps * step_us) / args.steps),
        flush_ms=med['whole'] - args.steps * step_us * 1e-3,
        phases_us=phases_us, phases_sum_us=sum(phases_us.values()),
        clocked_cost_pct=100 * (med['clocked'] / med['whole'] - 1),
        rates_hz=dict(e=float(spikes[:net.n_exc].double().mean()) / seconds,
                      i=float(spikes[net.n_exc:].double().mean()) / seconds),
        spikes_per_step=float(spikes.sum()) / args.steps,
        deliveries_per_step=float((spikes * degree).sum()) / args.steps,
        **extra,
        split_bytes=net.plan.split.numel() * net.plan.split.element_size(),
        weights_after=dict(mean=float(first['weights'].double().mean()),
                           sd=float(first['weights'].double().std())),
        memory_peak_bytes=torch.cuda.max_memory_allocated(device))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
