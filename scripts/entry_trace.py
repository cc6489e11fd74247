"""Put a benchmark cell's idle device time down to the port's spans, and
time what recording them costs.

    python3 scripts/entry_trace.py --workload coba_ei.4k --seed <n> \\
        [--seconds 10] [--windows 3] [--trials 2]

On a card, from the root of a checkout; prints one JSON line. Set-up is
a benchmark run's (``benchmark_torch/drivers/trials.py``): the cell's
inputs from the seed, the program, a warm trial. Then:

- ``cost``: the µs a span site costs the host, tracing off and on; then
  ``2 x --windows`` timed windows of ``--seconds`` each, as a run's
  window times them, with the port's tracing
  (``brainevent_torch.ops.tracing``) off and on in turns (off on on off
  ...), the profiler off: each window's µs a step, and the ms a trial
  of each span in the windows with tracing on;
- ``traced``: ``--trials`` trials under ``torch.profiler`` with tracing
  on, profiled as a ``--trace 1`` run profiles its trials (their outputs
  kept, so that the allocator works as there): the window's device idle
  share; the share
  idle while the host was inside a root span
  (``brainevent_torch.EINet.run``); the root spans' host time a step and
  their routes;
  each span's host time and the idle time inside it and none of its
  children, summed by name; the idle gaps, by the innermost span and
  host op at their middle; and how far each span lies from the
  profiler's event of the same name.

The benchmark itself never turns tracing on; this script is how the
entry's pieces are measured on the card.
"""

import argparse
import bisect
import json
import os
import sys
import time
import warnings
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def overlap_ns(busy, start: int, end: int) -> int:
    """The part of ``[start, end]`` that the sorted, disjoint intervals
    *busy* cover."""
    total = 0
    i = max(bisect.bisect_right([b[0] for b in busy], start) - 1, 0)
    for b0, b1 in busy[i:]:
        if b0 >= end:
            break
        total += max(0, min(b1, end) - max(b0, start))
    return total


def attribute(window, busy, host, spans) -> dict:
    """The idle time of a profiled *window* ``(start, end)`` in ns, with
    the device *busy* in the merged intervals *busy*, put down to the
    program's *spans* (:class:`brainevent_torch.ops.tracing.Span`) and
    to the *host* ops ``(start, end, name, is_runtime_call)`` of the
    window's thread: the root spans' summed length (``entry_ns``) and
    idle time (``entry_idle_ns``); by span name, the idle time inside a
    span and none of its children, and the host time; the idle gaps by
    the innermost span and host op at their middle."""
    from benchmark_torch.harness.trace import _HostOps
    w0, w1 = window

    def idle(s):
        a, b = max(s.start_ns, w0), min(s.end_ns, w1)
        return max(0, b - a) - overlap_ns(busy, a, b) if b > a else 0
    children = defaultdict(list)
    for s in spans:
        children[s.parent_id].append(s)
    idle_by_span, host_by_span = defaultdict(int), defaultdict(int)
    for s in spans:
        idle_by_span[s.name] += idle(s) - sum(
            idle(c) for c in children[s.span_id])
        host_by_span[s.name] += s.end_ns - s.start_ns
    roots = children[None]
    gaps, t = [], w0
    for start, end in list(busy) + [[w1, w1]]:
        if start > t:
            gaps.append((t, start))
        t = max(t, end)
    ops = _HostOps(list(host))
    program = _HostOps([(s.start_ns, s.end_ns, s.name, False)
                        for s in spans])
    gap_ns = defaultdict(int)
    for start, end in gaps:
        middle = (start + end) // 2
        label = ops.label(middle)
        where = program.label(middle)
        if where in program.names and not (
                label == where or label.startswith(where + ' > ')):
            label = f'{where} > {label}'
        gap_ns[label] += end - start
    return dict(entry_ns=sum(s.end_ns - s.start_ns for s in roots),
                entry_idle_ns=sum(idle(s) for s in roots),
                idle_by_span=dict(idle_by_span),
                host_by_span=dict(host_by_span),
                idle_gaps=dict(sorted(gap_ns.items(),
                                      key=lambda kv: -kv[1])))


def timeline(events):
    """From the profiler's events: the window ``(start, end)``, the
    merged device-busy intervals inside it and the host ops of its
    thread, as ``benchmark_torch.harness.trace.summarize`` finds them."""
    from benchmark_torch.harness import trace
    w = next(e for e in events if e.name() == trace.WINDOW)
    w0, w1, thread = w.start_ns(), w.end_ns(), w.start_thread_id()
    kinds = [trace._kind(e) for e in events]
    host_names = {e.name() for e, k in zip(events, kinds)
                  if k not in trace.DEVICE_KINDS}
    device, host = [], []
    for e, kind in zip(events, kinds):
        if kind in trace.DEVICE_KINDS and e.name() not in host_names:
            start, end = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if end > start:
                device.append((start, end))
        elif (kind in trace.HOST_KINDS and e.start_thread_id() == thread
              and e.name() != trace.WINDOW):
            host.append((e.start_ns(), e.end_ns(), trace._short(e.name()),
                         kind in ('cuda_runtime', 'cuda_driver')))
    return (w0, w1), trace._merge(device), host


def clock_offset_us(events, spans) -> float:
    """The largest distance, at either end, between a span and the
    profiler's nearest event of the same name."""
    by_name = defaultdict(list)
    for e in events:
        by_name[e.name()].append(e)
    worst = 0
    for s in spans:
        e = min(by_name[s.name], key=lambda e: abs(e.start_ns() - s.start_ns))
        worst = max(worst, abs(e.start_ns() - s.start_ns),
                    abs(e.end_ns() - s.end_ns))
    return worst * 1e-3


def span_us(tracing, n: int = 20000) -> dict:
    """The host's µs a span site costs, tracing off and on (the profiler
    off)."""
    out = {}
    for on in (False, True):
        if on:
            tracing.enable()
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span('brainevent_torch.probe', route='sim'):
                pass
        out['on' if on else 'off'] = (time.perf_counter() - t0) / n * 1e6
        tracing.disable()
        tracing.drain()
    return out


def measure(cell: str, seed: int, seconds: float, windows: int,
            trials: int, device, traffic=None) -> dict:
    """The JSON line's content for *cell* on *device* (*traffic*: a
    smaller mix in the cell's, for a rehearsal on the CPU)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from benchmark_torch.drivers import trials as driver
    from benchmark_torch.harness import spec, trace
    from benchmark_torch.harness.device import sync
    from brainevent_torch.ops import tracing
    cell_file = spec.load_part('workloads', cell)
    cfg = spec.load_part('configs', cell_file['config'])
    if traffic is None:
        traffic = spec.load_part('traffic', cell_file['traffic'])
    reference = spec.load_module('reference', cfg['name'])
    inputs = reference.make_inputs(cfg, traffic, seed, device)
    system = driver.System(cfg, traffic, inputs, device)
    n_steps, first = traffic['trial_steps'], 0

    def trials_from(first, **kw):
        return driver.run_trials(system, device, n_steps, first,
                                 driver.Sample(seed, 0), **kw)
    driver.run_trials(system, device, traffic['warm_steps'], 0,
                      driver.Sample(seed, 0), count=1)
    cost = dict(off=[], on=[], span_us=span_us(tracing))
    host_ns, n_on = defaultdict(int), 0
    for k in range(2 * windows):
        on = k % 4 in (1, 2)
        if on:
            tracing.enable()
        window = trials_from(first, seconds=seconds)
        tracing.disable()
        for s in tracing.drain():
            host_ns[s.name] += s.end_ns - s.start_ns
        n_on += on * len(window.ends)
        first += len(window.ends)
        cost['on' if on else 'off'].append(window.seconds / window.steps
                                           * 1e6)
    cost['host_ms_per_trial'] = {k: v * 1e-6 / n_on
                                 for k, v in host_ns.items()}

    outputs = []
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    tracing.enable()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)
        with profile(activities=activities) as prof:
            with record_function(trace.WINDOW):
                traced = trials_from(first, count=trials,
                                     reduce=outputs.append)
                sync(device)
    tracing.disable()
    spans = tracing.drain()
    events = prof.profiler.kineto_results.events()
    window, busy, host = timeline(events)
    parts = attribute(window, busy, host, spans)
    w_ns = window[1] - window[0]
    steps = traced.steps
    found = trace.summarize(events)
    return dict(
        cell=cell, seed=seed, cost=cost, traced=dict(
            trials=len(traced.ends), steps=steps, window_s=w_ns * 1e-9,
            device_idle_pct=100.0 * (1 - found.busy_s / found.window_s),
            entry_idle_pct=100.0 * parts['entry_idle_ns'] / w_ns,
            entry_us_per_step=parts['entry_ns'] * 1e-3 / steps,
            routes=sorted({s.attrs['route'] for s in spans
                           if s.parent_id is None}),
            idle_s_by_span={k: v * 1e-9
                            for k, v in parts['idle_by_span'].items()},
            host_s_by_span={k: v * 1e-9
                            for k, v in parts['host_by_span'].items()},
            idle_gaps=[[k, v * 1e-9] for k, v in
                       list(parts['idle_gaps'].items())[:trace.TOP]],
            clock_offset_us=clock_offset_us(events, spans)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, default=10.0)
    parser.add_argument('--windows', type=int, default=3)
    parser.add_argument('--trials', type=int, default=2)
    args = parser.parse_args(argv)
    os.environ['BRAINEVENT_TORCH_BUILD_DIR'] = str(
        ROOT / 'benchmark_torch' / '.cache' / 'kernels')
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark_torch.harness import device as dev
    t0 = time.perf_counter()
    device = dev.require_cuda(1)
    line = measure(args.workload, args.seed, args.seconds, args.windows,
                   args.trials, device)
    line.update(device=torch.cuda.get_device_name(device),
                nvidia_smi=dev.power_limit(), torch=torch.__version__,
                seconds=time.perf_counter() - t0)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
