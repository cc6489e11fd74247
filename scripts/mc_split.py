"""K23's step on the card, split into its parts: the whole step, the update
with the Poisson draw (and the barrier), and the grid barrier alone.

    python3 scripts/mc_split.py [--scale 1.0] [--steps 20000] [--warm 5000] \\
        [--seed 7] [--turns 3]

On a card, from the root of a checkout; prints one JSON line. It draws
the microcircuit at *scale* on the card (``MicrocircuitNet``'s own
builder), runs ``--warm`` steps from a drawn state past the start-up
transient, then times in turns, by CUDA events around one launch of
``--steps`` steps each:

- ``whole``: K23 over the network, from the warm state;
- ``no_rows``: K23 from the same state over the same neurons with every
  row empty: the same update, draw and barrier, no scatter;
- ``barrier``: ``--steps`` grid barriers alone on K23's grid.

``update`` is ``no_rows - barrier`` and ``scatter`` is ``whole -
no_rows``, in µs a step. It also prints the populations' rates over the
timed steps of the first ``whole`` launch, the spikes and synapse events a
step, K23's grid and the memory peak.
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
    parser.add_argument('--scale', type=float, default=1.0)
    parser.add_argument('--steps', type=int, default=20000)
    parser.add_argument('--warm', type=int, default=5000)
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--turns', type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import brainevent_torch as bt
    from brainevent_torch.models import microcircuit as mc
    from brainevent_torch.ops import cuda_build
    from brainevent_torch.ops.core import cuda_stream

    device = torch.device('cuda')
    t0 = time.perf_counter()
    net = bt.MicrocircuitNet(scale=args.scale, seed=args.seed, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    empty = bt.MicrocircuitNet(
        scale=args.scale, device=device,
        row_ptr=torch.zeros(net.num + 1, dtype=torch.int32),
        targets=torch.zeros(0, dtype=torch.int32),
        weights=torch.zeros(0, dtype=torch.int16),
        delays=torch.zeros(0, dtype=torch.uint8))
    empty.depth = net.depth  # the whole network's ring
    state = net.run(args.warm, state=net.init_state(
        torch.Generator().manual_seed(args.seed + 1)))
    blocks = mc.mc_sim_grid(net.num, device)
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
        err = barriers(args.steps, blocks, device.index or 0,
                       cuda_stream(device))
        if err:
            raise RuntimeError(f'mc_sim_barriers_launch: CUDA error {err}')

    times = {'whole': [], 'no_rows': [], 'barrier': []}
    first = None
    for _ in range(args.turns):
        us, out = timed(lambda: net.run(args.steps, state=state))
        times['whole'].append(us)
        first = first or out
        times['no_rows'].append(timed(
            lambda: empty.run(args.steps, state=state))[0])
        times['barrier'].append(timed(barrier)[0])
    counts = (first.spike_count - state.spike_count).to(torch.int64)
    degree = (net.row_ptr[1:] - net.row_ptr[:-1]).to(torch.int64)
    seconds = args.steps * net.params.dt * 1e-3
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device), nvidia_smi=power_limit(),
        torch=torch.__version__, cuda=torch.version.cuda, scale=args.scale,
        num=net.num, synapses=net.targets.numel(), depth=net.depth,
        blocks=blocks, steps=args.steps, warm=args.warm,
        build_s=build_s, us_per_step=times,
        split_us=dict(update=med['no_rows'] - med['barrier'],
                      scatter=med['whole'] - med['no_rows'],
                      barrier=med['barrier']),
        rates_hz=[float(counts[a:b].double().mean()) / seconds for a, b in
                  zip(net.pop_start[:-1], net.pop_start[1:])],
        spikes_per_step=float(counts.sum()) / args.steps,
        events_per_step=float((counts * degree).sum()) / args.steps,
        memory_peak_bytes=torch.cuda.max_memory_allocated(device))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
