"""K21's HH step on the card, split into its parts: the whole step, the
update alone, and the grid barrier alone.

    python3 scripts/hh_split.py [--scale 100] [--steps 5000] [--warm 2000] \\
        [--seed 7] [--turns 3]

On a card, from the root of a checkout; prints one JSON line. It draws
Brette's Hodgkin-Huxley network (``HHNet``) at *scale* (100: the cell
``coba_hh.400k``'s 400,000 neurons), runs ``--warm`` steps from a drawn
state past the start-up transient, then times in turns, by CUDA events
around one launch of ``--steps`` steps each:

- ``whole``: K21's HH instance over the table, from the warm state: the
  update, the scatter of the step's spikes and the barrier;
- ``no_rows``: the same instance from the same state over a table of no
  targets: the same fold, update, ballot and barrier, no scatter (the HH
  update costs the same whatever its input);
- ``barrier``: ``--steps`` grid barriers alone on the same grid;
- ``npt8``: ``whole`` on the instance of eight neurons a thread (two
  blocks an SM), the variant the co-resident grid would take next;
- ``clocked``: ``whole`` with the program's tracing on, so on the clocked
  instance, whose warps time their update, scatter and barrier.

``update`` is ``no_rows - barrier`` and ``scatter`` is ``whole -
no_rows``, in µs a step. ``phases_us`` is the clocked launches' mean
warp's time a step in each phase (their median), to compare with the
subtraction (the in-kernel barrier holds the wait for the slowest block),
and ``clocked_cost_pct`` the clocked launch's time over ``whole``'s. It
also prints the instance's grid, the E and I
rates and the spikes and hits a step over the timed steps of the first
``whole`` launch, and the memory peak.
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
    parser.add_argument('--scale', type=float, default=100.0)
    parser.add_argument('--steps', type=int, default=5000)
    parser.add_argument('--warm', type=int, default=2000)
    parser.add_argument('--seed', type=int, default=7)
    parser.add_argument('--turns', type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import brainevent_torch as bt
    from brainevent_torch.models import hh_net as hn
    from brainevent_torch.ops import cuda_build, tracing
    from brainevent_torch.ops.core import cuda_stream

    device = torch.device('cuda')
    t0 = time.perf_counter()
    net = bt.HHNet(scale=args.scale, seed=args.seed, device=device)
    empty = bt.HHNet(scale=args.scale, device=device,
                     conn_all=torch.zeros(net.num, 0, dtype=torch.int32))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = net.run(args.warm, state=net.init_state(
        torch.Generator().manual_seed(args.seed + 1)))
    npt, blocks = hn.hh_sim_grid(net.num, device)
    p = net.step_params()
    barriers = cuda_build.function('einet_sim_barriers_launch', [
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
            raise RuntimeError(f'einet_sim_barriers_launch: CUDA error {err}')

    def npt8():
        out = [x.clone() for x in state]
        hn.einet_sim_hh(*out, net.conn_all, args.steps, p, net.n_exc, npt=8)
        return out

    def clocked():
        tracing.enable()
        try:
            return net.run(args.steps, state=state)
        finally:
            tracing.disable()
            tracing.drain()

    times = {'whole': [], 'clocked': [], 'no_rows': [], 'barrier': [],
             'npt8': []}
    first, sessions = None, []
    for _ in range(args.turns):
        us, out = timed(lambda: net.run(args.steps, state=state))
        times['whole'].append(us)
        first = first or out
        us, out_c = timed(clocked)
        times['clocked'].append(us)
        sessions.append(tracing.session_counts())
        if not all(torch.equal(x, y) for x, y in zip(out_c, out)):
            raise RuntimeError('the clocked instance differs from the plain '
                               'one')
        times['no_rows'].append(timed(
            lambda: empty.run(args.steps, state=state))[0])
        times['barrier'].append(timed(barrier)[0])
        us, out8 = timed(npt8)
        times['npt8'].append(us)
        if not all(torch.equal(x, y) for x, y in zip(out8, first)):
            raise RuntimeError('the NPT 8 instance differs from the NPT '
                               f'{npt} one')
    counts = (first.spike_count - state.spike_count).to(torch.int64)
    seconds = args.steps * net.params.dt * 1e-3
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    spikes = float(counts.sum()) / args.steps
    warp_steps = blocks * hn.SIM_BLOCK // 32 * args.steps
    phases_us = {name: sorted(c[f'brainevent_torch.HHNet.phase_ns.{name}']
                              for c in sessions)[len(sessions) // 2]
                 / warp_steps * 1e-3 for name in hn.PHASES}
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(device), nvidia_smi=power_limit(),
        torch=torch.__version__, cuda=torch.version.cuda, scale=args.scale,
        num=net.num, n_conn=net.conn_all.shape[1], npt=npt, blocks=blocks,
        npt8_blocks=-(-net.num // (8 * hn.SIM_BLOCK)), steps=args.steps,
        warm=args.warm, build_s=build_s, us_per_step=times,
        split_us=dict(update=med['no_rows'] - med['barrier'],
                      scatter=med['whole'] - med['no_rows'],
                      barrier=med['barrier']),
        phases_us=phases_us, phases_sum_us=sum(phases_us.values()),
        clocked_cost_pct=100 * (med['clocked'] / med['whole'] - 1),
        rates_hz=[float(counts[:net.n_exc].double().mean()) / seconds,
                  float(counts[net.n_exc:].double().mean()) / seconds],
        spikes_per_step=spikes, hits_per_step=spikes * net.conn_all.shape[1],
        memory_peak_bytes=torch.cuda.max_memory_allocated(device))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
