"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell (``BENCHMARK.json``'s ``workloads``) names its files:
``workloads/<cell>.json``, its configuration's and traffic's files, the
configuration's reference, work and driver modules, and a reader in
``metrics/`` for each metric it reports. With ``--trace 0`` the result
line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, read from a profiled window after the timed one.

A host without the cards prints no result and exits with 2. The kernels
build at first use into ``benchmark_torch/.cache/kernels`` of this
checkout, and every later run of a cell there loads them.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / 'benchmark_torch' / '.cache'
FORBIDDEN = ('jax', 'brainevent_tpu', 'bench', 'chip_smoke')


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def measure(cell: str, seed: int, seconds: float, trace: bool, device,
            clock0: float, traffic=None) -> dict:
    """One run of *cell* on *device* (the CPU runs the program's twins,
    for the tests): the record its metric readers read. *traffic*
    replaces the cell's traffic file (a test's smaller mix). A cell file
    that ``BENCHMARK.json`` does not list yet runs as well."""
    from benchmark_torch.harness import spec
    cell_file = spec.load_part('workloads', cell)
    entry = next((e for e in spec.benchmark()['workloads']
                  if e['name'] == cell), cell_file)
    for key in ('config', 'traffic'):
        if cell_file[key] != entry[key]:
            raise ValueError(f'{cell}: BENCHMARK.json names {key} '
                             f'{entry[key]!r}, its file {cell_file[key]!r}')
    cfg = spec.load_part('configs', cell_file['config'])
    if traffic is None:
        traffic = spec.load_part('traffic', cell_file['traffic'])
    driver = spec.load_module('drivers', cfg['driver'])
    record = driver.run(cell, cfg, traffic, cell_file['limits'], seed,
                        seconds, trace, device, clock0, log)
    record['platform'] = 'gpu' if device.type == 'cuda' else 'cpu'
    return record


def main(argv=None) -> int:
    args = parse(argv)
    os.environ['BRAINEVENT_TORCH_BUILD_DIR'] = str(CACHE / 'kernels')
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    sys.path.insert(0, str(ROOT))
    import torch
    t_torch = time.perf_counter()
    from benchmark_torch.harness import device as dev, output, spec
    bench = spec.benchmark()
    chips = spec.cell_entry(bench, spec.check_name(args.workload))['chips']
    try:
        device = dev.require_cuda(chips)
    except dev.NoDevice as e:
        log(f'run.py: {e}')
        return 2
    torch.empty(1, device=device)
    log(f'set-up, seconds since the start: import torch '
        f'{t_torch - CLOCK0:.3f}, CUDA context '
        f'{time.perf_counter() - CLOCK0:.3f}')
    record = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), device, CLOCK0)
    info = dev.describe(device, chips)
    print(f'device {info["kind"]} count {torch.cuda.device_count()} '
          f'(using {chips}); nvidia-smi: {dev.power_limit()}; torch '
          f'{torch.__version__} cuda {torch.version.cuda}', flush=True)
    loaded = sorted(m for m in sys.modules
                    if m.split('.')[0] in FORBIDDEN)
    if loaded:
        raise RuntimeError(f'the run imported {loaded}: the benchmark '
                           f'measures the port alone')
    output.emit(output.result_line(bench, record, bool(args.trace), info))
    return 0


if __name__ == '__main__':
    sys.exit(main())
