"""One profiled window: what ran on the device, and what the host did
while the device was idle.

``torch.profiler`` (CUPTI on the card) records every kernel, copy and
memset with its device start and end, and every host op on the same
clock. From them:

- ``busy_s``: the union of the device operations' intervals inside the
  window; ``window_s``: the window's length; their ratio is the device's
  busy share;
- ``device_op_s``: the device operations' summed durations, and their
  count (``n_device_ops``), by kind;
- ``device_ops``: the operations that took the most device time, by name;
- ``idle_gaps``: the device's idle time, summed by what the host was
  doing at the middle of each gap: the innermost host op running there
  (a CUDA runtime call with the op that made it), else the benchmark's
  own span around the call into the program.
"""

import bisect
import dataclasses
import warnings
from collections import defaultdict

import torch

from .device import sync

WINDOW = 'benchmark: profiled window'
DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_KINDS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver',
              'python_function')
TOP = 10
NAME_CHARS = 120
_NOISE = ('void ', '(anonymous namespace)::', 'at::native::')


def _short(name: str) -> str:
    """A kernel's name without its boilerplate, cut to NAME_CHARS."""
    for word in _NOISE:
        name = name.replace(word, '')
    return name[:NAME_CHARS]


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_op_s: float
    n_device_ops: int
    n_by_kind: dict
    device_ops: list
    idle_gaps: list


def profile(fn, device: torch.device):
    """Run *fn* under the profiler (host ops, and the device's on a card)
    and wait for the device; returns ``(fn's result, Trace)``."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with warnings.catch_warnings():
        # the profiler warns that it keeps one cycle's events: one is run
        warnings.simplefilter('ignore', UserWarning)
        with _profile(activities=activities) as prof:
            with record_function(WINDOW):
                out = fn()
                sync(device)
    return out, summarize(prof.profiler.kineto_results.events())


def _kind(event) -> str:
    """The event's activity kind (``kernel``, ``gpu_memcpy``,
    ``gpu_memset``, ``cpu_op``, ``cuda_runtime``, ...); where the profiler
    does not give it, from the event's device and name."""
    try:
        return event.activity_type()
    except AttributeError:
        pass
    name = event.name()
    if event.device_type() == torch.autograd.DeviceType.CUDA:
        return ('gpu_memcpy' if name.startswith('Memcpy') else
                'gpu_memset' if name.startswith('Memset') else 'kernel')
    return 'cuda_runtime' if name.startswith('cuda') else 'cpu_op'


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class _HostOps:
    """The host ops of one thread, nested, to find the innermost op
    running at a time."""

    def __init__(self, ops):
        ops.sort(key=lambda o: (o[0], -o[1]))
        self.starts = [o[0] for o in ops]
        self.ends = [o[1] for o in ops]
        self.names = [o[2] for o in ops]
        self.runtime = [o[3] for o in ops]
        self.parent = []
        stack = []
        for i, (start, end, _, _) in enumerate(ops):
            while stack and self.ends[stack[-1]] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def label(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        while i >= 0 and self.ends[i] < t_ns:
            i = self.parent[i]
        if i < 0:
            return 'host outside any recorded op'
        if self.runtime[i] and self.parent[i] >= 0:
            return f'{self.names[self.parent[i]]} > {self.names[i]}'
        return self.names[i]


def summarize(events) -> Trace:
    """Reduce the profiler's raw events to a :class:`Trace`."""
    window = None
    for e in events:
        if e.name() == WINDOW:
            window = (e.start_ns(), e.end_ns(), e.start_thread_id())
            break
    if window is None:
        raise RuntimeError('the profiled window was not recorded')
    w0, w1, thread = window
    kinds = [_kind(e) for e in events]
    # a span the host records also shows on the device's timeline, under
    # the same name: it is no device operation
    host_names = {e.name() for e, kind in zip(events, kinds)
                  if kind not in DEVICE_KINDS}
    device, host = [], []
    by_kind = defaultdict(int)
    op_ns = defaultdict(int)
    for e, kind in zip(events, kinds):
        if kind in DEVICE_KINDS and e.name() not in host_names:
            start, end = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if end <= start:
                continue
            device.append((start, end))
            by_kind[kind] += 1
            op_ns[_short(e.name())] += end - start
        elif (kind in HOST_KINDS and e.start_thread_id() == thread
              and e.name() != WINDOW):
            host.append((e.start_ns(), e.end_ns(), _short(e.name()),
                         kind in ('cuda_runtime', 'cuda_driver')))
    busy = _merge(device)
    gaps, t = [], w0
    for start, end in busy + [[w1, w1]]:
        if start > t:
            gaps.append((t, start))
        t = max(t, end)
    ops = _HostOps(host)
    gap_ns = defaultdict(int)
    for start, end in gaps:
        gap_ns[ops.label((start + end) // 2)] += end - start

    def top(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(window_s=(w1 - w0) * 1e-9,
                 busy_s=sum(end - start for start, end in busy) * 1e-9,
                 device_op_s=sum(end - start for start, end in device) * 1e-9,
                 n_device_ops=len(device), n_by_kind=dict(by_kind),
                 device_ops=top(op_ns), idle_gaps=top(gap_ns))
