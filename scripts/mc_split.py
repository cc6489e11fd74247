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
  row empty, and so no row in the grid's lists: the same update, draw and
  barrier, no scatter;
- ``barrier``: ``--steps`` grid barriers alone on K23's grid;
- ``clocked``: ``whole`` with the program's tracing on, so on K23's
  clocked instance, whose warps time their update, scatter and barrier.

``update`` is ``no_rows - barrier`` and ``scatter`` is ``whole -
no_rows``, in µs a step: the grid pass over the step's list (its read,
loads and atomics). ``phases_us`` is the clocked launches' mean warp's time a step
in each phase (their median), to compare with the subtraction (the
in-kernel barrier holds the wait for the slowest block), and
``clocked_cost_pct`` the clocked launch's time over ``whole``'s. It also
prints the populations' rates over the timed steps of
the first ``whole`` launch, the spikes and synapse events a step, K23's
grid and the memory peak.

Then, from the warm state, :data:`LAUNCHES` one-step K23 launches, each
from the last one's state, give each step's spikes (the ``spike_count``
differences) and so what K23's blocks add (``engagement``): the median and
99th percentile over steps of the grid pass's synapses a block (its
contiguous 1/B of the step's spiking rows), and the most spikes a step.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCHES = 300  # one-step launches of the engagement counter


def power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def engagement(net, state, blocks: int, launches: int = LAUNCHES) -> dict:
    """What K23's blocks add over *launches* one-step launches from
    *state* (see the module's docstring)."""
    import torch
    degree = (net.row_ptr[1:] - net.row_ptr[:-1]).to(torch.int64)
    spikes, grid = [], []
    for _ in range(launches):
        out = net.run(1, state=state)
        spiked = (out.spike_count - state.spike_count).to(torch.int64)
        spikes.append(int(spiked.sum()))
        grid.append(-(-int((spiked * degree).sum()) // blocks))
        state = out

    def median_p99(xs):
        x = torch.tensor(xs, dtype=torch.float64)
        median, p99 = torch.quantile(x, torch.tensor(
            [0.5, 0.99], dtype=torch.float64)).tolist()
        return median, p99
    g50, g99 = median_p99(grid)
    return dict(launches=launches, max_spikes=max(spikes),
                grid_block_synapses_median=g50,
                grid_block_synapses_p99=g99)


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
    from brainevent_torch.ops import cuda_build, tracing
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

    def clocked():
        tracing.enable()
        try:
            return net.run(args.steps, state=state)
        finally:
            tracing.disable()
            tracing.drain()

    times = {'whole': [], 'clocked': [], 'no_rows': [], 'barrier': []}
    first, sessions = None, []
    for _ in range(args.turns):
        us, out = timed(lambda: net.run(args.steps, state=state))
        times['whole'].append(us)
        first = first or out
        us, out_c = timed(clocked)
        times['clocked'].append(us)
        sessions.append(tracing.session_counts())
        if not all(torch.equal(getattr(out_c, k), getattr(out, k))
                   for k in ('v', 'i_syn', 'ref', 'ring', 'spike_count')):
            raise RuntimeError('the clocked instance differs from the plain '
                               'one')
        times['no_rows'].append(timed(
            lambda: empty.run(args.steps, state=state))[0])
        times['barrier'].append(timed(barrier)[0])
    counts = (first.spike_count - state.spike_count).to(torch.int64)
    degree = (net.row_ptr[1:] - net.row_ptr[:-1]).to(torch.int64)
    seconds = args.steps * net.params.dt * 1e-3
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    warp_steps = blocks * mc.MC_BLOCK // 32 * args.steps
    phases_us = {
        name: sorted(c[f'brainevent_torch.MicrocircuitNet.phase_ns.{name}']
                     for c in sessions)[len(sessions) // 2]
        / warp_steps * 1e-3 for name in mc.PHASES}
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device), nvidia_smi=power_limit(),
        torch=torch.__version__, cuda=torch.version.cuda, scale=args.scale,
        num=net.num, synapses=net.targets.numel(), depth=net.depth,
        blocks=blocks, steps=args.steps, warm=args.warm,
        build_s=build_s, us_per_step=times,
        split_us=dict(update=med['no_rows'] - med['barrier'],
                      scatter=med['whole'] - med['no_rows'],
                      barrier=med['barrier']),
        phases_us=phases_us, phases_sum_us=sum(phases_us.values()),
        clocked_cost_pct=100 * (med['clocked'] / med['whole'] - 1),
        rates_hz=[float(counts[a:b].double().mean()) / seconds for a, b in
                  zip(net.pop_start[:-1], net.pop_start[1:])],
        spikes_per_step=float(counts.sum()) / args.steps,
        events_per_step=float((counts * degree).sum()) / args.steps,
        engagement=engagement(net, state, blocks),
        memory_peak_bytes=torch.cuda.max_memory_allocated(device))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
