"""The ``trials`` traffic over the cortical microcircuit
(``pd_microcircuit``): whole simulations of simulated time, back to back,
each from one of a few initial states, as ``trials`` runs them.

``trials.run`` builds only the EI networks' states, so this module builds
the configuration's entry (``MicrocircuitNet``) and its states
(``MicrocircuitState``: a Poisson key each) in a :class:`System` of its
own, and otherwise runs the trials as ``trials.run`` does: set-up, a warm
trial, the window, a traced run's profiled trials, the memory peak, then
the plain reference over the sampled trials. Besides, a traced run turns
the program's spans on for its profiled trials only, and records the
summed host time of the entry's root spans (``entry_host_s``) beside
those trials' wall time (``traced_seconds``).
"""

import gc
import importlib
import time

import torch

from benchmark_torch.drivers.trials import Sample, Trials, run_trials
from benchmark_torch.harness import spec, trace as tracing
from benchmark_torch.harness.device import sync

ROOT_SPAN = 'brainevent_torch.MicrocircuitNet.run'
FIELDS = ('v', 'i_syn', 'ref', 'ring', 'spike_count')


def _import(dotted: str):
    module, _, name = dotted.rpartition('.')
    return getattr(importlib.import_module(module), name)


def _as_param(value):
    """A configuration's value in the program's form: lists as tuples."""
    if isinstance(value, list):
        return tuple(_as_param(v) for v in value)
    return value


class System:
    """The program under test: the configuration's entry at the traffic's
    scale over the network that set-up drew, with the trials' initial
    states in the program's type. Refuses a program whose parameters are
    not the configuration's."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device):
        entry = _import(cfg['entry'])
        self.net = entry(scale=traffic['scale'], device=device,
                         **inputs['program'])
        if (self.net.num, self.net.depth) != (inputs['num'], inputs['depth']):
            raise ValueError(f'{cfg["entry"]} built {self.net.num} neurons '
                             f'and a ring of {self.net.depth}, the reference '
                             f'{inputs["num"]} and {inputs["depth"]}')
        stated = {**cfg['network'], **cfg['neuron'], **cfg['initial_state']}
        for key, value in stated.items():
            if hasattr(self.net.params, key):
                got = getattr(self.net.params, key)
                if got != _as_param(value):
                    raise ValueError(f'{cfg["entry"]} runs {key}={got}; the '
                                     f'configuration states {value}')
        self.label = f'{entry.__name__}.{cfg["call"]}'
        self.call = getattr(self.net, cfg['call'])
        state_cls = _import(cfg['state']['class'])
        self.states = [state_cls(**s) for s in inputs['states']]

    def trial(self, index: int, n_steps: int) -> dict:
        """One trial from initial state ``index`` (taken in turn)."""
        with torch.profiler.record_function(self.label):
            out = self.call(n_steps,
                            state=self.states[index % len(self.states)])
        return {k: getattr(out, k) for k in FIELDS}


def _profiled(system: System, device, n_steps: int, first: int,
              sample: Sample, count: int):
    """*count* trials under the profiler with the program's spans on:
    ``(Trials, Trace, outputs, entry host seconds or None)``."""
    from brainevent_torch.ops import tracing as spans
    outputs = []
    spans.drain()
    spans.enable()
    try:
        traced, profile = tracing.profile(
            lambda: run_trials(system, device, n_steps, first, sample,
                               count=count, reduce=outputs.append), device)
    finally:
        spans.disable()
    roots = [s for s in spans.drain()
             if s.parent_id is None and s.name == ROOT_SPAN]
    host = sum(s.end_ns - s.start_ns for s in roots) * 1e-9 if roots else None
    return traced, profile, outputs, host


def run(cell: str, cfg: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device, clock0: float, log) -> dict:
    """One run of *cell*; returns the record the metric readers read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _import(cfg['entry'])  # a program without the entry stops here
    reference = spec.load_module('reference', cfg['name'])
    work = spec.load_module('work', cfg['name'])
    stages = [('imports', time.perf_counter())]
    inputs = reference.make_inputs(cfg, traffic, seed, device)
    sync(device)
    stages.append(('inputs', time.perf_counter()))
    system = System(cfg, traffic, inputs, device)
    sync(device)
    stages.append(('network', time.perf_counter()))
    run_trials(system, device, traffic['warm_steps'], 0, Sample(seed, 0),
               count=1)
    gc.collect()
    stages.append(('warm trial', time.perf_counter()))
    log('set-up, seconds since the start: ' + ', '.join(
        f'{name} {t - clock0:.3f}' for name, t in stages))
    from brainevent_torch.ops import cuda_build
    build_s = cuda_build.last_build_seconds()
    n_steps = traffic['trial_steps']
    sample = Sample(seed, traffic['check_trials'])
    reduce = (lambda out: work.reduce(cfg, inputs, out)) if trace else None
    setup_s = time.perf_counter() - clock0
    window = run_trials(system, device, n_steps, 0, sample, seconds=seconds,
                        reduce=reduce)
    per_trial = window.trial_seconds()
    log(f'window: {len(per_trial)} trials of {n_steps} steps in '
        f'{window.seconds!r} s; a trial {min(per_trial)!r} s to '
        f'{max(per_trial)!r} s; set-up {setup_s!r} s, nvcc build '
        f'{build_s!r} s')
    traced, profile, entry_host_s = Trials(n_steps=n_steps), None, None
    if trace:
        # the traced trials' outputs are reduced after the profiler stops,
        # so that the window holds the program's device work alone
        traced, profile, outputs, entry_host_s = _profiled(
            system, device, n_steps, len(per_trial), sample,
            traffic['trace_trials'])
        traced.reduced = sum(reduce(out) for out in outputs)
        del outputs
        log(f'traced: {len(traced.ends)} trials, device operations '
            f'{profile.n_by_kind}, busy {profile.busy_s!r} s of '
            f'{profile.window_s!r} s; the entry\'s root spans '
            f'{entry_host_s!r} s')
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == 'cuda' else 0)
    del system
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    checks, failed = {}, 0
    t0 = time.perf_counter()
    for index, got in sorted(sample.kept.items()):
        state = inputs['states'][index % len(inputs['states'])]
        want = reference.simulate(cfg, traffic, inputs, state, n_steps)
        values = reference.compare(cfg, inputs, got, want)
        failed += any(values[k] > limits[k] for k in limits)
        for k, v in values.items():
            checks[k] = max(checks.get(k, v), v)
    log(f'reference: {len(sample.kept)} trials in '
        f'{time.perf_counter() - t0!r} s')
    missing = set(limits) - set(checks)
    if missing:
        raise KeyError(f'limits name numbers the comparison lacks: {missing}')

    runs = [window] + ([traced] if trace else [])
    record = dict(cell=cell, setup_s=setup_s, build_s=build_s,
                  steps=window.steps, seconds=window.seconds,
                  trials=len(per_trial), memory_peak_bytes=memory_peak,
                  checks={k: (checks[k], limits[k]) for k in limits},
                  failed=failed, checked=len(sample.kept),
                  attempted=sum(len(r.ends) for r in runs))
    if trace:
        record.update(
            trace=profile, traced_steps=traced.steps,
            traced_seconds=traced.seconds, entry_host_s=entry_host_s,
            window_work=work.count(cfg, inputs, window.reduced,
                                   len(window.ends), n_steps),
            traced_work=work.count(cfg, inputs, traced.reduced,
                                   len(traced.ends), n_steps))
    return record
