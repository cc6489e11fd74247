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
the sums and forgets them.
"""

import itertools
import time
from typing import NamedTuple, Optional

import torch

__all__ = ['Span', 'span', 'enable', 'disable', 'enabled', 'drain',
           'count', 'drain_counts']


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
        self.range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.range.__exit__(*exc)
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
    """Record spans from now on."""
    global _enabled
    _enabled = True


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


def drain_counts() -> dict:
    """``{counter: sum}`` (ints) since the last call, and forget them."""
    out = {name: sum(int(v) for v in values)
           for name, values in _counts.items()}
    _counts.clear()
    return out
