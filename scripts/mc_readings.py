"""The readings the limits of ``pd_microcircuit.77k``, ``hpc_stdp.112k``,
``coba_hh.400k`` and ``vogels_istdp.200k`` are set from, on the card:
``benchmark_torch/readings.py`` for the cells that run through a driver
of their own (``mc_trials``, ``stdp_trials``, ``hh_trials``,
``istdp_trials``).

    python3 scripts/mc_readings.py [--cell pd_microcircuit.77k] \
        --program <seed,...> --control <seed,...>

For each ``--program`` seed: set-up as a run makes it, one trial of the
cell's length from the first initial state through the program, then the
plain reference over the same trial, and the comparison's numbers. For
each ``--control`` seed: the same trial through the reference computed in
bfloat16, the precision below the configuration's float32, in the
program's place. Prints one JSON line a seed, with the spikes of the
reference's trial and the seconds the seed took.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = 'pd_microcircuit.77k'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--program', default='')
    parser.add_argument('--control', default='')
    parser.add_argument('--cell', default=CELL)
    args = parser.parse_args(argv)
    os.environ['BRAINEVENT_TORCH_BUILD_DIR'] = str(
        ROOT / 'benchmark_torch' / '.cache' / 'kernels')
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark_torch.harness import device as dev, spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = dev.require_cuda(1)
    print(f'device {torch.cuda.get_device_name(device)}; nvidia-smi: '
          f'{dev.power_limit()}', flush=True)
    cell = spec.load_part('workloads', args.cell)
    cfg = spec.load_part('configs', cell['config'])
    traffic = spec.load_part('traffic', cell['traffic'])
    ref = spec.load_module('reference', cell['config'])
    driver = spec.load_module('drivers', cfg['driver'])
    n_steps = traffic['trial_steps']
    for kind, seeds in (('program', args.program), ('control', args.control)):
        for seed in [int(s) for s in seeds.split(',') if s]:
            t0 = time.perf_counter()
            inputs = ref.make_inputs(cfg, traffic, seed, device)
            state = inputs['states'][0]
            if kind == 'program':
                system = driver.System(cfg, traffic, inputs, device)
                got = system.trial(0, n_steps)
                del system
                gc.collect()
            else:
                got = ref.simulate(cfg, traffic, inputs, state, n_steps,
                                   dtype=torch.bfloat16)
            t1 = time.perf_counter()
            want = ref.simulate(cfg, traffic, inputs, state, n_steps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            values = ref.compare(cfg, inputs, got, want)
            print(json.dumps(dict(
                kind=kind, cell=args.cell, seed=seed, readings=values,
                spikes=int(want['spike_count'].sum()),
                reference_s=t2 - t1, seconds=t2 - t0)), flush=True)
            del inputs, got, want
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
