"""The ``trials`` traffic: whole simulations of simulated time, back to
back, each from a fresh initial state.

A trial is one call of the configuration's entry (``run(n_steps, inp=,
state=)``) from one of a few initial states that set-up draws from the
seed, taken in turn, so that no random number is drawn in the window. The
window starts at the first trial's call and ends at the ``synchronize``
after the first trial that finishes once ``seconds`` have passed; its
rate is all the steps of all its trials over all that time. A traced run
then runs ``trace_trials`` more trials under the profiler.

After the last trial the run reads the device's memory peak, frees the
program, and runs the plain reference over ``check_trials`` trials drawn
from the seed among those it finished (only those are kept), from the
same initial states; the configuration's ``compare`` gives the numbers
the cell's limits hold.
"""

import dataclasses
import gc
import importlib
import random
import time

import torch

from benchmark_torch.harness import spec, trace as tracing
from benchmark_torch.harness.device import sync


def _import(dotted: str):
    module, _, name = dotted.rpartition('.')
    return getattr(importlib.import_module(module), name)


class System:
    """The program under test: the configuration's entry, built from the
    configuration's arguments, the traffic's size and the inputs that
    set-up made, with the trials' initial states in the program's type."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device):
        entry = _import(cfg['entry'])
        self.net = entry(**cfg['network'], scale=traffic['scale'],
                         device=device, **inputs['program'])
        if (self.net.num, self.net.n_exc) != (inputs['num'], inputs['n_exc']):
            raise ValueError(f'{cfg["entry"]} built {self.net.num} neurons '
                             f'({self.net.n_exc} excitatory), the reference '
                             f'{inputs["num"]} ({inputs["n_exc"]})')
        for key, value in cfg['neuron'].items():
            got = getattr(self.net.params, key)
            if got != value:
                raise ValueError(f'{cfg["entry"]} runs {key}={got}; the '
                                 f'configuration states {value}')
        self.label = f'{entry.__name__}.{cfg["call"]}'
        self.call = getattr(self.net, cfg['call'])
        self.inp = cfg['drive']['inp']
        state_cls = _import(cfg['state']['class'])
        neurons_cls = _import(cfg['state']['neurons'])
        self.states = [
            state_cls(neurons=neurons_cls(v=s['v'], t_last=s['t_last']),
                      g_e=s['g_e'], g_i=s['g_i'],
                      spike_count=s['spike_count'])
            for s in inputs['states']]

    def trial(self, index: int, n_steps: int) -> dict:
        """One trial from initial state ``index`` (taken in turn)."""
        with torch.profiler.record_function(self.label):
            out = self.call(n_steps, inp=self.inp,
                            state=self.states[index % len(self.states)])
        return dict(v=out.neurons.v, t_last=out.neurons.t_last, g_e=out.g_e,
                    g_i=out.g_i, spike_count=out.spike_count)


class Sample:
    """A uniform sample of *k* of the trials a run finishes, drawn from
    the seed as they finish (reservoir sampling): only the sampled
    trials' outputs are kept, so the run's memory is one trial's."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.seen = 0
        self.kept = {}

    def offer(self, index: int, output: dict) -> None:
        if len(self.kept) < self.k:
            self.kept[index] = output
        else:
            slot = self.rng.randrange(self.seen + 1)
            if slot < self.k:
                del self.kept[sorted(self.kept)[slot]]
                self.kept[index] = output
        self.seen += 1


@dataclasses.dataclass
class Trials:
    """Trials run back to back: when each ended, and (a traced run only)
    the sum over them of the work module's reduction of each output."""
    n_steps: int
    ends: list = dataclasses.field(default_factory=list)
    start: float = 0.0
    reduced: object = None

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.start

    @property
    def steps(self) -> int:
        return self.n_steps * len(self.ends)

    def trial_seconds(self) -> list:
        return [b - a for a, b in zip([self.start] + self.ends, self.ends)]


def run_trials(system: System, device, n_steps: int, first: int,
               sample: Sample, *, seconds: float = 0.0, count: int = 0,
               reduce=None) -> Trials:
    """Trials from initial state *first* on, each waited for: until one
    finishes *seconds* after the first call, or *count* of them. Each
    output is offered to *sample*, and given to *reduce* where one is
    given: what that returns (queued on the device, not waited for) is
    summed over the trials."""
    out = Trials(n_steps=n_steps)
    out.start = time.perf_counter()
    while True:
        index = first + len(out.ends)
        output = system.trial(index, n_steps)
        if reduce is not None:
            part = reduce(output)
            if part is not None:
                out.reduced = (part if out.reduced is None
                               else out.reduced + part)
        sample.offer(index, output)
        del output
        sync(device)
        out.ends.append(time.perf_counter())
        if (count and len(out.ends) >= count) or (
                not count and out.ends[-1] - out.start >= seconds):
            return out


def percentile(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def run(cell: str, cfg: dict, traffic: dict, limits: dict, seed: int,
        seconds: float, trace: bool, device, clock0: float, log) -> dict:
    """One run of *cell*; returns the record the metric readers read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        f'{max(per_trial)!r} s, p95 {percentile(per_trial, 0.95)!r} s; '
        f'set-up {setup_s!r} s, nvcc build {build_s!r} s')
    traced, profile = None, None
    if trace:
        # the traced trials' outputs are reduced after the profiler stops,
        # so that the window holds the program's device work alone
        outputs = []
        traced, profile = tracing.profile(
            lambda: run_trials(system, device, n_steps, len(per_trial),
                               sample, count=traffic['trace_trials'],
                               reduce=outputs.append), device)
        traced.reduced = sum(reduce(out) for out in outputs)
        del outputs
        log(f'traced: {len(traced.ends)} trials, device operations '
            f'{profile.n_by_kind}, busy {profile.busy_s!r} s of '
            f'{profile.window_s!r} s')
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

    runs = [window] + ([traced] if traced else [])
    record = dict(cell=cell, setup_s=setup_s, build_s=build_s,
                  steps=window.steps, seconds=window.seconds,
                  trials=len(per_trial), memory_peak_bytes=memory_peak,
                  checks={k: (checks[k], limits[k]) for k in limits},
                  failed=failed, checked=len(sample.kept),
                  attempted=sum(len(r.ends) for r in runs))
    if trace:
        record.update(
            trace=profile, traced_steps=traced.steps,
            window_work=work.count(cfg, inputs, window.reduced,
                                   len(window.ends), n_steps),
            traced_work=work.count(cfg, inputs, traced.reduced,
                                   len(traced.ends), n_steps))
    return record
