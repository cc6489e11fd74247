"""The ``trials`` traffic over Vogels et al. 2011's network with inhibitory
plasticity (``vogels_istdp``): whole simulations of simulated time, back
to back, each from one of a few initial states and from the network's
initial weights, as ``trials`` runs them (the model draws no random
number, so a trial is its initial state's).

``trials.run`` builds only the EI networks' states, so this module builds
the configuration's entry (``IstdpNet``) and its states (``IstdpState``)
in a :class:`System` of its own, and otherwise runs the trials as
``stdp_trials.run`` does: set-up, a warm trial, the window, a traced run's
profiled trials with the program's spans on, the memory peak, then the
plain reference over the sampled trials. Besides, a traced run records the
program's counters over the profiled trials (``plastic_updates``: the pre
and post updates of K24's iSTDP instance) and that instance's device time
there (``istdp_kernel_s``). A program without ``IstdpNet`` stops at once,
before any set-up.
"""

import gc
import time

import torch

from benchmark_torch.drivers.mc_trials import _as_param, _import
from benchmark_torch.drivers.trials import (Sample, Trials, percentile,
                                            run_trials)
from benchmark_torch.harness import spec, trace as tracing
from benchmark_torch.harness.device import sync

ROOT_SPAN = 'brainevent_torch.IstdpNet.run'
COUNTERS = ('brainevent_torch.IstdpNet.pre_updates',
            'brainevent_torch.IstdpNet.post_updates')
KERNEL = 'istdp_sim_kernel'
FIELDS = ('v', 'g_ampa', 'g_gaba', 'ref', 'ring', 'spike_count', 'weights',
          'apre', 'apost')


class System:
    """The program under test: the configuration's entry at the traffic's
    scale over the network that set-up drew, with the trials' initial
    states in the program's type. Refuses a program whose parameters are
    not the configuration's."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device):
        entry = _import(cfg['entry'])
        params = entry.__dataclass_fields__['params'].default
        stated = {**cfg['network'], **cfg['neuron'], **cfg['initial_state']}
        for key, value in stated.items():
            if hasattr(params, key) and getattr(params, key) != _as_param(
                    value):
                raise ValueError(f'{cfg["entry"]} runs {key}='
                                 f'{getattr(params, key)}; the '
                                 f'configuration states {value}')
        self.net = entry(scale=traffic['scale'], device=device,
                         **inputs['program'])
        if (self.net.num, self.net.n_exc) != (inputs['num'], inputs['ne']):
            raise ValueError(f'{cfg["entry"]} built {self.net.num} neurons '
                             f'({self.net.n_exc} excitatory), the reference '
                             f'{inputs["num"]} ({inputs["ne"]})')
        self.label = f'{entry.__name__}.{cfg["call"]}'
        self.call = getattr(self.net, cfg['call'])
        state_cls = _import(cfg['state']['class'])
        self.states = [state_cls(**s) for s in inputs['states']]

    def trial(self, index: int, n_steps: int) -> dict:
        """One trial from initial state ``index`` (taken in turn)."""
        with torch.profiler.record_function(self.label):
            out = self.call(n_steps,
                            state=self.states[index % len(self.states)])
        return dict({k: getattr(out, k) for k in FIELDS}, step=out.step)


def _profiled(system: System, device, n_steps: int, first: int,
              sample: Sample, count: int):
    """*count* trials under the profiler with the program's spans on:
    ``(Trials, Trace, outputs, entry host seconds, plastic updates)``,
    the last two None where the program records no such span or
    counter."""
    from brainevent_torch.ops import tracing as spans
    outputs = []
    spans.drain()
    spans.drain_counts()
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
    counts = spans.drain_counts()
    updates = (sum(counts[k] for k in COUNTERS)
               if all(k in counts for k in COUNTERS) else None)
    return traced, profile, outputs, host, updates


def kernel_seconds(profile) -> float:
    """The iSTDP instance's device time in a profiled window (its kernel by
    name), or None where it did not run."""
    found = [s for name, s in profile.device_ops if name.startswith(KERNEL)]
    return sum(found) if found else None


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
        f'{max(per_trial)!r} s, p95 {percentile(per_trial, 0.95)!r} s; '
        f'set-up {setup_s!r} s, nvcc build {build_s!r} s')
    traced, profile = Trials(n_steps=n_steps), None
    entry_host_s = updates = None
    if trace:
        # the traced trials' outputs are reduced after the profiler stops,
        # so that the window holds the program's device work alone
        traced, profile, outputs, entry_host_s, updates = _profiled(
            system, device, n_steps, len(per_trial), sample,
            traffic['trace_trials'])
        traced.reduced = sum(reduce(out) for out in outputs)
        del outputs
        log(f'traced: {len(traced.ends)} trials, device operations '
            f'{profile.n_by_kind}, busy {profile.busy_s!r} s of '
            f'{profile.window_s!r} s; the entry\'s root spans '
            f'{entry_host_s!r} s; plastic updates {updates!r}')
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
            plastic_updates=updates, istdp_kernel_s=kernel_seconds(profile),
            window_work=work.count(cfg, inputs, window.reduced,
                                   len(window.ends), n_steps),
            traced_work=work.count(cfg, inputs, traced.reduced,
                                   len(traced.ends), n_steps))
    return record
