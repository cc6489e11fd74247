# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The readers of the whole-trial kernels' phases (``<phase>_us_per_step.
{stdp,hh,mc}``) on counts made by hand: each reads the program's session
counts (``tracing.session_counts``), the phase's ns over the warps' steps
in µs, and nothing off the card, without a profiled window, where a
counter is missing, or from a program without phase clocks."""

import pytest

from benchmark_torch.harness import spec
from brainevent_torch.ops import tracing

from _torch_one_thread import one_torch_thread  # noqa: F401

PHASES = {'stdp': ('HpcStdpNet', ('update', 'walk', 'barrier', 'flush')),
          'hh': ('HHNet', ('update', 'scatter', 'barrier')),
          'mc': ('MicrocircuitNet', ('update', 'scatter', 'barrier')),
          'istdp': ('IstdpNet', ('update', 'scatter', 'walk', 'post',
                                'barrier'))}
CELLS = {'stdp': 'hpc_stdp.112k', 'hh': 'coba_hh.400k',
         'mc': 'pd_microcircuit.77k', 'istdp': 'vogels_istdp.200k'}
METRICS = [(f'{phase}_us_per_step.{kernel}', kernel, k)
           for kernel, (_, phases) in PHASES.items()
           for k, phase in enumerate(phases)]
CARD = dict(platform='gpu', trace=object())


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    yield
    tracing.enable()   # a new, empty session
    tracing.disable()


def _session(kernel, ns, warp_steps):
    """A traced session of two launches of *kernel*'s entry: phase k's ns
    ``ns[k]``, split between them."""
    entry, phases = PHASES[kernel]
    tracing.enable()
    tracing.count_phases(entry, [x // 2 for x in ns], phases,
                         warp_steps // 2)
    tracing.count_phases(entry, [x - x // 2 for x in ns], phases,
                         warp_steps - warp_steps // 2)
    tracing.disable()
    tracing.drain_counts()   # what a run drains stays in the session


@pytest.mark.parametrize('name, kernel, k', METRICS,
                         ids=[m[0] for m in METRICS])
def test_a_reader_is_its_phases_ns_over_the_warps_steps(name, kernel, k):
    read = spec.load_module('metrics', name).read
    ns = [1_000_000 * (q + 2) + 7 for q in range(len(PHASES[kernel][1]))]
    _session(kernel, ns, 3168 * 10_000)
    assert read(CARD) == pytest.approx(ns[k] / (3168 * 10_000) / 1e3,
                                       rel=1e-12)
    assert read(dict(CARD, platform='cpu')) is None
    assert read(dict(platform='gpu')) is None


@pytest.mark.parametrize('missing', ['phase', 'warp_steps', 'other_entry'])
def test_a_reader_without_its_counters_reads_nothing(missing):
    read = spec.load_module('metrics', 'walk_us_per_step.stdp').read
    tracing.enable()
    if missing == 'phase':
        tracing.count('brainevent_torch.HpcStdpNet.phase_warp_steps', 100)
    elif missing == 'warp_steps':
        tracing.count('brainevent_torch.HpcStdpNet.phase_ns.walk', 100)
    else:
        tracing.count_phases('HHNet', [1, 2, 3],
                             ('update', 'scatter', 'barrier'), 100)
    tracing.disable()
    assert read(CARD) is None


def test_a_program_without_phase_clocks_reads_nothing(monkeypatch):
    """The parent of the phase clocks has no ``session_counts``: its
    traced runs leave the ten metrics out of their lines."""
    _session('mc', [10, 20, 30], 64)
    monkeypatch.delattr(tracing, 'session_counts')
    for name, _, _ in METRICS:
        assert spec.load_module('metrics', name).read(CARD) is None, name


def test_each_reader_has_its_entry_in_the_benchmark():
    """Each metric moves its cell's end-to-end metric, in the kernels'
    layer, in µs a step, lower better, from a program counter."""
    bench = spec.benchmark()
    entries = {m['name']: m for m in bench['per_layer']}
    cells = {e['name']: e['workloads'] for e in bench['end_to_end']
             if 'workloads' in e}
    for name, kernel, _ in METRICS:
        m = entries[name]
        assert m['workloads'] == [CELLS[kernel]]
        assert (m['unit'], m['better'], m['source'], m['layer']) == (
            'us/step', 'lower', 'program_counter', 'kernels')
        assert CELLS[kernel] in cells[m['moves']]
