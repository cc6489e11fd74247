# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Spans at the layer boundaries of the port's entries, kept in memory.

Tracing is off unless :func:`enable` turned it on. Off, :func:`span`
checks one module-level flag and returns a shared no-op context manager:
it reads no clock, records nothing and opens no profiler range, so the
entries cost what they cost without it. On, each span records its name,
its start and end (``time.time_ns()``, the clock of ``torch.profiler``'s
host events, so that spans and a device trace line up), its id, its
parent's id, the id of its run (the id of the outermost span open when
it started, shared by every span under it) and the attributes it was
given; it also enters ``torch.profiler.record_function`` under the same
name, so that a profiler's timeline carries it.

:func:`drain` returns the finished spans, oldest first, and forgets
them. There is no exporter and no setting: the caller that turned
tracing on reads what it recorded::

    from brainevent_torch.ops import tracing
    tracing.enable()
    net.run(100_000)
    tracing.disable()
    root = next(s for s in tracing.drain() if s.parent_id is None)
    root.attrs['route']        # 'sim_cluster', 'sim', 'sim_table' or 'loop'

Span names carry the prefix ``brainevent_torch.``. Spans nest in the
order they are opened; they are meant for one thread. They are the
entries' boundaries, a few a call whatever its number of steps; the
launch counts of :mod:`~brainevent_torch.ops.core` count the kernels.

Beside the spans, an entry may add what its kernels counted to a named
counter (:func:`count`), only while tracing is on (:func:`enabled`): a
number, or a one-element tensor that stays where it is, so that the entry
does not wait for the card. :func:`drain_counts` reads them back, returns
the sums and forgets them. :func:`session_counts` returns the sums of
every value counted since the last :func:`enable`, whether or not they
were drained since: the benchmark's metric readers read a traced run's
counters there (``benchmark_torch/metrics``), whatever the run drained.

The whole-trial kernels (K21's HH instance, K23, K24) have a clocked
instance, which their entries launch exactly while tracing is on: each
warp times its launch in the phases of the step, and the entry adds the
grid's warps' ns in each phase to ``brainevent_torch.<Entry>.phase_ns.
<phase>`` and the grid's warps times the launch's steps to
``brainevent_torch.<Entry>.phase_warp_steps`` (:func:`count_phases`), so
that their ratio is the mean warp's ns a step in the phase.
"""

import itertools
import time
from typing import NamedTuple, Optional

import torch

__all__ = ['Span', 'span', 'enable', 'disable', 'enabled', 'drain',
           'count', 'drain_counts', 'session_counts', 'count_phases']


class Span(NamedTuple):
    """One finished span; times in ns of ``time.time_ns()``."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    run: int
    attrs: dict


_enabled = False
_finished = []
_counts = {}
_session = {}                   # every value counted since enable()
_open = []                      # (span id, run id) of the open spans
_ids = itertools.count()


class _NoSpan:
    """What :func:`span` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ('name', 'attrs', 'ids', 'start_ns', 'range')

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        span_id = next(_ids)
        parent, run = _open[-1] if _open else (None, span_id)
        self.ids = (span_id, parent, run)
        _open.append((span_id, run))
        self.range = torch.profiler.record_function(self.name)
        # Under the profiler the range's entry and exit take up to tens of
        # µs, and the profiler stamps the range inside them: the span
        # starts at the middle of the entry and ends after the exit, within
        # a few µs of the profiler's stamps (the exit's stamp comes late
        # in it).
        before = time.time_ns()
        self.range.__enter__()
        self.start_ns = (before + time.time_ns()) // 2
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end_ns = time.time_ns()
        _open.pop()
        _finished.append(Span(self.name, self.start_ns, end_ns, *self.ids,
                              self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records the span *name* with *attrs* while
    tracing is on, and the shared no-op while it is off."""
    if not _enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def enable() -> None:
    """Record spans from now on, and start a new session of counts
    (:func:`session_counts`)."""
    global _enabled
    _enabled = True
    _session.clear()


def disable() -> None:
    """Record no more spans; those finished are kept for :func:`drain`."""
    global _enabled
    _enabled = False


def drain() -> list:
    """The finished spans, in the order they started, and forget them."""
    spans = sorted(_finished, key=lambda s: s.span_id)
    _finished.clear()
    return spans


def enabled() -> bool:
    """Whether spans and counts are being recorded."""
    return _enabled


def count(name: str, value) -> None:
    """Add *value* (an int, or a one-element tensor, read back only by
    :func:`drain_counts`) to the counter *name* while tracing is on."""
    if _enabled:
        _counts.setdefault(name, []).append(value)
        _session.setdefault(name, []).append(value)


def _sums(counts: dict) -> dict:
    return {name: sum(int(v) for v in values)
            for name, values in counts.items()}


def drain_counts() -> dict:
    """``{counter: sum}`` (ints) since the last call, and forget them."""
    out = _sums(_counts)
    _counts.clear()
    return out


def session_counts() -> dict:
    """``{counter: sum}`` (ints) of every value counted since the last
    :func:`enable`; :func:`drain_counts` does not clear them."""
    return _sums(_session)


def count_phases(entry: str, phases, names, warp_steps: int) -> None:
    """Count a clocked launch of *entry*'s kernel: ``phases[k]`` (the
    grid's warps' ns in the phase ``names[k]``) to
    ``brainevent_torch.<entry>.phase_ns.<name>``, and *warp_steps* (the
    grid's warps times the launch's steps) to
    ``brainevent_torch.<entry>.phase_warp_steps``."""
    for k, name in enumerate(names):
        count(f'brainevent_torch.{entry}.phase_ns.{name}', phases[k])
    count(f'brainevent_torch.{entry}.phase_warp_steps', warp_steps)
