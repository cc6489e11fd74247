"""K24's step on the card, split into its parts: the whole step, the step
without the facilitation, the update with the Poisson draw (and the
barriers), and the two grid barriers alone.

    python3 scripts/stdp_split.py [--scale 10] [--steps 5000] [--warm 2000] \\
        [--seed 7] [--turns 3]

On a card, from the root of a checkout; prints one JSON line. It draws
NEST's HPC benchmark network at *scale* on the card
(``build_hpc_network``), runs ``--warm`` steps from a drawn state past the start-up
transient, then times in turns, by CUDA events around one launch of
``--steps`` steps each, from that state:

- ``whole``: K24 over the network;
- ``no_columns``: K24 over the same rows with an empty CSC, so no
  facilitation (the weights then drift down a little over the launch);
- ``no_rows``: K24 over the same neurons with every row and column
  empty: the same update, draw, traces and barriers, no pass (the
  neurons, driven by the Poisson input alone, fire faster);
- ``barrier``: ``2 --steps`` grid barriers alone on K24's grid.

``update`` is ``no_rows - barrier``, ``facilitation`` ``whole -
no_columns`` and ``depression_delivery`` ``no_columns - no_rows``, in µs a
step. It also prints the populations' rates over the first ``whole``
launch, its spikes, deliveries, depressions and facilitations a step (the
program's counters), K24's grid and the memory peak.
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
    from brainevent_torch.ops import cuda_build, tracing
    from brainevent_torch.ops.core import cuda_stream

    device = torch.device('cuda')
    t0 = time.perf_counter()
    net = bt.HpcStdpNet(scale=args.scale, seed=args.seed, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    no_columns = bt.HpcStdpNet(
        scale=args.scale, device=device, targets=net.targets,
        plastic_ptr=net.plastic_ptr, static_ptr=net.static_ptr,
        weights=net.weights)
    no_columns.plan = no_columns.plan._replace(
        col_ptr=torch.zeros_like(net.plan.col_ptr))
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

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / args.steps, out

    def barrier():
        err = barriers(2 * args.steps, blocks, device.index or 0,
                       cuda_stream(device))
        if err:
            raise RuntimeError(f'mc_sim_barriers_launch: CUDA error {err}')

    times = {'whole': [], 'no_columns': [], 'no_rows': [], 'barrier': []}
    first = counts = None
    for turn in range(args.turns):
        if turn == 0:
            tracing.drain_counts()
            tracing.enable()
        us, out = timed(lambda: net.run(args.steps, state=state))
        if turn == 0:
            tracing.disable()
            counts = tracing.drain_counts()
            tracing.drain()
            first = out
        times['whole'].append(us)
        times['no_columns'].append(timed(
            lambda: no_columns.run(args.steps, state=state))[0])
        times['no_rows'].append(timed(
            lambda: empty.run(args.steps, state=bare))[0])
        times['barrier'].append(timed(barrier)[0])
    spikes = (first.spike_count - state.spike_count).to(torch.int64)
    degree = (net.static_ptr[1:] - net.static_ptr[:-1]).to(torch.int64)
    degree[:net.n_exc] += (net.plastic_ptr[1:]
                           - net.plastic_ptr[:-1]).to(torch.int64)
    seconds = args.steps * net.params.dt * 1e-3
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device), nvidia_smi=power_limit(),
        torch=torch.__version__, cuda=torch.version.cuda, scale=args.scale,
        num=net.num, n_exc=net.n_exc, synapses=net.targets.numel(),
        plastic=net.n_plastic, blocks=blocks,
        npt=-(-net.num // (blocks * hs.HPC_BLOCK)), steps=args.steps,
        warm=args.warm, build_s=build_s, us_per_step=times,
        split_us=dict(update=med['no_rows'] - med['barrier'],
                      facilitation=med['whole'] - med['no_columns'],
                      depression_delivery=med['no_columns'] - med['no_rows'],
                      barrier=med['barrier']),
        rates_hz=dict(e=float(spikes[:net.n_exc].double().mean()) / seconds,
                      i=float(spikes[net.n_exc:].double().mean()) / seconds),
        spikes_per_step=float(spikes.sum()) / args.steps,
        deliveries_per_step=float((spikes * degree).sum()) / args.steps,
        depressions_per_step=counts.get(
            'brainevent_torch.HpcStdpNet.depressions', 0) / args.steps,
        facilitations_per_step=counts.get(
            'brainevent_torch.HpcStdpNet.facilitations', 0) / args.steps,
        weights_after=dict(mean=float(first.weights.double().mean()),
                           sd=float(first.weights.double().std())),
        memory_peak_bytes=torch.cuda.max_memory_allocated(device))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
