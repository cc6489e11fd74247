"""K24's step on the card, split into its parts: the step with its walk,
the update with the Poisson draw (and the barriers), the two grid barriers
alone, and the launch's flush.

    python3 scripts/stdp_split.py [--scale 10] [--steps 5000] [--warm 2000] \\
        [--seed 7] [--turns 3]

On a card, from the root of a checkout; prints one JSON line. It draws
NEST's HPC benchmark network at *scale* on the card
(``build_hpc_network``), runs ``--warm`` steps from a drawn state past the
start-up transient, then times in turns, by CUDA events around one K24
launch each (``stdp_sim`` on copies of the state, so not ``run``'s copy
of the weights), from that state:

- ``whole``: K24 over the network, ``--steps`` steps;
- ``half``: the same over half as many steps;
- ``no_rows``: K24 over the same neurons with every row empty: the same
  update, draw, traces and barriers, no walk and nothing to flush (the
  neurons, driven by the Poisson input alone, fire faster);
- ``barrier``: ``2 --steps`` grid barriers alone on K24's grid.

A launch is its steps and one flush, so ``step`` is ``(whole - half)``
over the steps between them, and ``flush`` (ms a launch) ``whole`` less
``--steps`` of them. ``update`` is ``no_rows - barrier`` and ``row_walk``
``step - no_rows``, in µs a step. It also prints the populations' rates
over the first ``whole`` launch, its spikes, deliveries, depressions and
facilitations a step (K24's counters), the share of the facilitations the
flush made, the walk's balance (``walk_balance``: the busiest block's work
a step, its plastic entries and facilitations, over the blocks' mean),
K24's grid, the split plan's bytes and the memory peak.
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
    parser.add_argument('--scale', type=float, default=10.0)
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
    t0 = time.perf_counter()
    net = bt.HpcStdpNet(scale=args.scale, seed=args.seed, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    empty = bt.HpcStdpNet(
        scale=args.scale, device=device,
        targets=torch.zeros(0, dtype=torch.int32),
        plastic_ptr=torch.zeros(net.n_exc + 1, dtype=torch.int32),
        static_ptr=torch.zeros(net.num + 1, dtype=torch.int32),
        weights=torch.zeros(0))
    state = net.run(args.warm, state=net.init_state(
        torch.Generator().manual_seed(args.seed + 1)))
    bare = state._replace(weights=empty.weights)
    blocks = hs.stdp_sim_grid(net.num, device)
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
        out = [getattr(st, k).clone() for k in hs.STATE_FIELDS]
        p = on.step_params(st.key, st.step)
        ms, _ = timed(lambda: hs.stdp_sim(
            *out, on.targets, on.plastic_ptr, on.static_ptr, n_steps, p,
            scratch=on.plan, counters=counters))
        return ms, dict(zip(hs.STATE_FIELDS, out))

    def barrier():
        err = barriers(2 * args.steps, blocks, device.index or 0,
                       cuda_stream(device))
        if err:
            raise RuntimeError(f'mc_sim_barriers_launch: CUDA error {err}')

    ms = {'whole': [], 'half': [], 'no_rows': [], 'barrier': []}
    first = None
    counters = torch.zeros(4, dtype=torch.int64, device=device)
    for turn in range(args.turns):
        x, out = launch(net, state, args.steps,
                        counters if turn == 0 else None)
        if turn == 0:
            first = out
        ms['whole'].append(x)
        ms['half'].append(launch(net, state, half)[0])
        ms['no_rows'].append(launch(empty, bare, args.steps)[0])
        ms['barrier'].append(timed(barrier)[0])
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    step_us = (med['whole'] - med['half']) * 1e3 / (args.steps - half)
    no_rows_us = med['no_rows'] * 1e3 / args.steps
    barrier_us = med['barrier'] * 1e3 / args.steps
    dep, fac, flush, busiest = counters.tolist()
    walk_work = dep + fac - flush
    spikes = (first['spike_count'] - state.spike_count).to(torch.int64)
    degree = (net.static_ptr[1:] - net.static_ptr[:-1]).to(torch.int64)
    degree[:net.n_exc] += (net.plastic_ptr[1:]
                           - net.plastic_ptr[:-1]).to(torch.int64)
    seconds = args.steps * net.params.dt * 1e-3
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device), nvidia_smi=power_limit(),
        torch=torch.__version__, cuda=torch.version.cuda, scale=args.scale,
        num=net.num, n_exc=net.n_exc, synapses=net.targets.numel(),
        plastic=net.n_plastic, blocks=blocks,
        npt=-(-net.num // (blocks * hs.HPC_BLOCK)), steps=args.steps,
        half=half, warm=args.warm, build_s=build_s,
        launch_ms=ms, us_per_step=dict(
            whole=med['whole'] * 1e3 / args.steps, step=step_us,
            no_rows=no_rows_us, barrier=barrier_us),
        split_us=dict(update=no_rows_us - barrier_us,
                      row_walk=step_us - no_rows_us, barrier=barrier_us,
                      flush_amortized=(med['whole'] * 1e3
                                       - args.steps * step_us) / args.steps),
        flush_ms=med['whole'] - args.steps * step_us * 1e-3,
        rates_hz=dict(e=float(spikes[:net.n_exc].double().mean()) / seconds,
                      i=float(spikes[net.n_exc:].double().mean()) / seconds),
        spikes_per_step=float(spikes.sum()) / args.steps,
        deliveries_per_step=float((spikes * degree).sum()) / args.steps,
        depressions_per_step=dep / args.steps,
        facilitations_per_step=fac / args.steps,
        flush_share=flush / fac if fac else None,
        walk_busiest_block_per_step=busiest / args.steps,
        walk_balance=busiest * blocks / walk_work if walk_work else None,
        split_bytes=net.plan.split.numel() * net.plan.split.element_size(),
        weights_after=dict(mean=float(first['weights'].double().mean()),
                           sd=float(first['weights'].double().std())),
        memory_peak_bytes=torch.cuda.max_memory_allocated(device))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
