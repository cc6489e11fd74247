"""The readings the limits of ``correct`` are set from, on the card.

    python3 benchmark_torch/readings.py --workload <cell> \\
        --program <seed,...> --control <seed,...> --perturbed <seed,...>

For each ``--program`` seed: set-up as a run makes it, one trial of the
cell's length from the first initial state through the program, then the
plain reference over the same trial, and the comparison's numbers. For
each ``--control`` seed: the same trial through the reference computed in
bfloat16, the precision below the configuration's float32, in the
program's place. For each ``--perturbed`` seed: the reference from the
same state with neuron 0 at its threshold, so that it spikes once more
at the first step, in the program's place: what a sound run reads once
a rounding decides one spike otherwise.
Prints one JSON line a seed. The benchmark's runs do not run this; it is
how the limits in ``workloads/<cell>.json`` were read.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--program', default='')
    parser.add_argument('--control', default='')
    parser.add_argument('--perturbed', default='')
    args = parser.parse_args(argv)
    os.environ['BRAINEVENT_TORCH_BUILD_DIR'] = str(
        ROOT / 'benchmark_torch' / '.cache' / 'kernels')
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark_torch.harness import device as dev, spec
    from benchmark_torch.drivers.trials import System
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = dev.require_cuda(1)
    print(f'device {torch.cuda.get_device_name(device)}; nvidia-smi: '
          f'{dev.power_limit()}', flush=True)
    cell = spec.load_part('workloads', args.workload)
    cfg = spec.load_part('configs', cell['config'])
    traffic = spec.load_part('traffic', cell['traffic'])
    ref = spec.load_module('reference', cell['config'])
    n_steps = traffic['trial_steps']
    for kind, seeds in (('program', args.program), ('control', args.control),
                        ('perturbed', args.perturbed)):
        for seed in [int(s) for s in seeds.split(',') if s]:
            t0 = time.perf_counter()
            inputs = ref.make_inputs(cfg, traffic, seed, device)
            state = inputs['states'][0]
            if kind == 'program':
                system = System(cfg, traffic, inputs, device)
                got = system.trial(0, n_steps)
                del system
                gc.collect()
            elif kind == 'control':
                got = ref.simulate(cfg, traffic, inputs, state, n_steps,
                                   dtype=torch.bfloat16)
            else:
                nudged = dict(state, v=state['v'].clone())
                nudged['v'][0] = cfg['neuron']['v_th']
                got = ref.simulate(cfg, traffic, inputs, nudged, n_steps)
            want = ref.simulate(cfg, traffic, inputs, state, n_steps)
            values = ref.compare(cfg, inputs, got, want)
            print(json.dumps(dict(
                kind=kind, cell=args.workload, seed=seed, readings=values,
                spikes=int(want['spike_count'].sum()),
                seconds=time.perf_counter() - t0)), flush=True)
            del inputs, got, want
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
