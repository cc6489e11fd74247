# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""brainevent_torch.ops.tracing, and the spans of ``EINet``'s entry.

Off, a span is one flag check and a shared no-op; on, one ``run`` records
its root span and a fixed few children whatever its number of steps, on
the clock of ``torch.profiler``'s host events, and computes the same
state bit for bit.
"""

import gc
import warnings

import pytest
import torch

from brainevent_torch.models import EINet
from brainevent_torch.models import networks as tnet
from brainevent_torch.ops import tracing

from _torch_one_thread import one_torch_thread  # noqa: F401

PREFIX = 'brainevent_torch.'
ROOT = 'brainevent_torch.EINet.run'
SIM = ['times', 'copies', 'upload', 'launch']
LOOP = ['times', 'loop']


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope='module')
def net():
    return EINet(scale=0.05, device='cpu')


def _fields(s):
    return [s.neurons.v, s.neurons.t_last, s.g_e, s.g_i, s.spike_count]


def _run(net, n_steps, route):
    if route == 'loop':
        return net._simulate(net.init_state(), n_steps, 20.0,
                             step_op=tnet.einet_step)
    return net.run(n_steps)


def _traced(fn):
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    return out, tracing.drain()


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
    return prof.profiler.kineto_results.events()


def test_off_records_nothing(net):
    assert tracing.span('a') is tracing.span('b', route='sim')
    events = _profiled(lambda: net.run(10))
    assert tracing.drain() == []
    assert not [e.name() for e in events if e.name().startswith(PREFIX)]


@pytest.mark.parametrize('route', ['sim', 'loop'])
def test_run_records_root_and_children(net, route):
    _, spans = _traced(lambda: (_run(net, 10, route), _run(net, 10, route)))
    first, second = spans[:len(spans) // 2], spans[len(spans) // 2:]
    for spans in (first, second):
        root = spans[0]
        assert root.name == ROOT and root.parent_id is None
        assert root.attrs == dict(num=net.num, n_steps=10, route=route)
        assert [s.name for s in spans[1:]] == [
            PREFIX + 'EINet.' + n for n in (SIM if route == 'sim' else LOOP)]
        assert {s.parent_id for s in spans[1:]} == {root.span_id}
        assert {s.run for s in spans} == {root.span_id}
        for s in spans[1:]:
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert first[0].run != second[0].run


@pytest.mark.parametrize('route', ['sim', 'loop'])
def test_span_count_does_not_grow_with_steps(net, route):
    counts = [len(_traced(lambda: _run(net, n, route))[1])
              for n in (10, 1000)]
    assert counts[0] == counts[1] == 1 + len(SIM if route == 'sim' else LOOP)


@pytest.mark.parametrize('route', ['sim', 'loop'])
def test_outputs_equal_with_tracing_on_and_off(net, route):
    off = _fields(_run(net, 300, route))
    on, _ = _traced(lambda: _run(net, 300, route))
    for a, b in zip(off, _fields(on)):
        assert torch.equal(a, b)


def test_spans_on_the_profilers_clock(net):
    def run():
        tracing.enable()
        try:
            net.run(200)
        finally:
            tracing.disable()
    # the first range a process opens under the profiler spends ~1 ms
    # setting up inside its event (the benchmark's window range takes it);
    # a garbage collection between a span's clock read and its range's
    # exit would stall that exit, which is no offset of the clocks
    _profiled(run)
    tracing.drain()
    gc.collect()
    gc.disable()
    try:
        events = _profiled(run)
    finally:
        gc.enable()
    spans = tracing.drain()
    assert len(spans) == 1 + len(SIM)
    by_name = {e.name(): e for e in events if e.name().startswith(PREFIX)}
    assert set(by_name) == {s.name for s in spans}
    for s in spans:
        e = by_name[s.name]
        assert abs(s.start_ns - e.start_ns()) < 200_000, s.name
        assert abs(s.end_ns - e.end_ns()) < 200_000, s.name


def test_session_counts_survive_drain_counts_until_enable():
    """``session_counts`` sums every value counted since the last
    ``enable``: ``drain_counts`` does not clear it, the next ``enable``
    does, and nothing is counted while tracing is off."""
    tracing.drain_counts()
    tracing.count('brainevent_torch.off', 5)
    tracing.enable()
    assert tracing.session_counts() == {}
    tracing.count('brainevent_torch.a', 2)
    tracing.count('brainevent_torch.a', torch.tensor([3]))
    assert tracing.drain_counts() == {'brainevent_torch.a': 5}
    tracing.count('brainevent_torch.b', torch.tensor(7))
    tracing.disable()
    tracing.count('brainevent_torch.a', 100)
    assert tracing.drain_counts() == {'brainevent_torch.b': 7}
    assert tracing.session_counts() == {'brainevent_torch.a': 5,
                                        'brainevent_torch.b': 7}
    assert tracing.session_counts() == {'brainevent_torch.a': 5,
                                        'brainevent_torch.b': 7}
    tracing.enable()
    assert tracing.session_counts() == {}
    tracing.disable()


def test_count_phases_names_each_phase_and_the_warps_steps():
    tracing.drain_counts()
    tracing.enable()
    tracing.count_phases('Net', torch.tensor([10, 20, 30]),
                         ('update', 'scatter', 'barrier'), 64)
    tracing.count_phases('Net', [1, 2, 3], ('update', 'scatter', 'barrier'),
                         16)
    tracing.disable()
    assert tracing.drain_counts() == {
        'brainevent_torch.Net.phase_ns.update': 11,
        'brainevent_torch.Net.phase_ns.scatter': 22,
        'brainevent_torch.Net.phase_ns.barrier': 33,
        'brainevent_torch.Net.phase_warp_steps': 80}


def _tiny(entry):
    """A small network of *entry* on the CPU (its twin loop)."""
    import brainevent_torch as bt
    if entry == 'HpcStdpNet':
        return bt.HpcStdpNet(scale=0.02, device='cpu',
                             params=bt.HpcStdpParams(ce=90, ci=22))
    if entry == 'HHNet':
        return bt.HHNet(scale=0.05, device='cpu')
    if entry == 'IstdpNet':
        return bt.IstdpNet(scale=0.1, device='cpu')
    return bt.MicrocircuitNet(scale=0.02, device='cpu')


WHOLE_TRIAL = ['HpcStdpNet', 'HHNet', 'MicrocircuitNet', 'IstdpNet']


@pytest.mark.parametrize('entry', WHOLE_TRIAL)
def test_the_cpu_loops_count_no_phase(entry):
    """The whole-trial entries' loops on the CPU have no phase clocks:
    traced, they count nothing under ``phase_``."""
    net = _tiny(entry)
    tracing.enable()
    try:
        net.run(30)
    finally:
        tracing.disable()
    tracing.drain()
    counts = tracing.session_counts()
    assert not [k for k in counts if '.phase_' in k], counts
    assert tracing.drain_counts() == counts


@pytest.mark.parametrize('entry', WHOLE_TRIAL)
def test_whole_trial_spans_on_the_profilers_clock(entry):
    """Each span of a whole-trial entry starts and ends within 50 µs of the
    profiler's ``record_function`` event of the same name: the spans read
    the clock of the profiler's host events. A run's events are compared
    after a first profiled run (the profiler's set-up) with the garbage
    collector off; of three runs the closest counts, so that a stall of
    this host between a clock read and its range is no offset of the
    clocks, which every run would show."""
    net = _tiny(entry)

    def run():
        tracing.enable()
        try:
            net.run(20)
        finally:
            tracing.disable()
    _profiled(run)
    tracing.drain()
    worst = []
    for _ in range(3):
        gc.collect()
        gc.disable()
        try:
            events = _profiled(run)
        finally:
            gc.enable()
        spans = tracing.drain()
        names = [PREFIX + entry + '.' + n for n in ('run', 'copies',
                                                     'launch')]
        assert [s.name for s in spans] == names
        by_name = {e.name(): e for e in events
                   if e.name().startswith(PREFIX)}
        assert set(by_name) == set(names)
        worst.append(max(max(abs(s.start_ns - by_name[s.name].start_ns()),
                             abs(s.end_ns - by_name[s.name].end_ns()))
                         for s in spans))
    assert min(worst) < 50_000, worst


def test_span_left_by_an_exception_is_closed():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span('brainevent_torch.outer'):
            with tracing.span('brainevent_torch.inner'):
                raise ValueError
    with tracing.span('brainevent_torch.next'):
        pass
    spans = tracing.drain()
    assert [s.name for s in spans] == ['brainevent_torch.outer',
                                       'brainevent_torch.inner',
                                       'brainevent_torch.next']
    assert spans[2].parent_id is None and spans[2].run == spans[2].span_id


def _entry_trace():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / 'scripts' / \
        'entry_trace.py'
    spec = importlib.util.spec_from_file_location('entry_trace', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_idle_time_put_down_to_spans():
    """``scripts/entry_trace.py`` on a hand-made timeline: idle time
    counts inside the span holding it and none of its children, the
    entry's idle time only inside root spans, and a gap's label takes the
    innermost span's name only where a span holds its middle."""
    def s(name, start, end, span_id, parent_id):
        return tracing.Span(PREFIX + 'EINet.' + name, start, end, span_id,
                            parent_id, 0, {})
    spans = [s('run', 50, 950, 0, None), s('times', 50, 100, 1, 0),
             s('upload', 100, 270, 2, 0), s('launch', 270, 320, 3, 0)]
    host = [(50, 100, PREFIX + 'EINet.times', False),
            (150, 260, 'aten::_to_copy', False)]
    busy = [[100, 200], [300, 900]]
    parts = _entry_trace().attribute((0, 1100), busy, host, spans)
    assert parts['entry_ns'] == 900
    assert parts['entry_idle_ns'] == 50 + 100 + 50
    assert parts['idle_by_span'] == {
        PREFIX + 'EINet.run': 50, PREFIX + 'EINet.times': 50,
        PREFIX + 'EINet.upload': 70, PREFIX + 'EINet.launch': 30}
    assert parts['host_by_span'][PREFIX + 'EINet.upload'] == 170
    assert parts['idle_gaps'] == {
        'host outside any recorded op': 200,
        PREFIX + 'EINet.times': 100,
        PREFIX + 'EINet.upload > aten::_to_copy': 100}
