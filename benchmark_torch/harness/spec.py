"""Find the benchmark's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics. Everything that belongs to one of them
lives in a file of its own under ``benchmark_torch/``, found here by that
name:

- ``workloads/<cell>.json``: the cell's configuration, traffic and limits;
- ``configs/<config>.json``: the program entry, its arguments, the source;
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``reference/<config>.py``: the plain reference, its inputs and the
  comparison;
- ``work/<config>.py``: the operations and bytes the cell's trials need;
- ``metrics/<metric>.py``: the reader of one metric.

A new cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; no file here changes.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

_NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')


def check_name(name: str) -> str:
    """*name* if it is a benchmark name (letters, digits, ``_ . -``, at
    most 64, not starting with ``.`` or ``-``); else ``ValueError``."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f'not a benchmark name: {name!r}')
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    """The parsed ``BENCHMARK.json``."""
    return load_json(root / 'BENCHMARK.json')


def part(kind: str, name: str, suffix: str) -> Path:
    """The file of the part *name* of *kind* (a directory of
    ``benchmark_torch/``); ``FileNotFoundError`` if there is none."""
    path = BENCH_DIR / kind / f'{check_name(name)}{suffix}'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind} file for {name!r}: {path}')
    return path


def load_part(kind: str, name: str) -> dict:
    return load_json(part(kind, name, '.json'))


def load_module(kind: str, name: str):
    """Import ``benchmark_torch/<kind>/<name>.py`` (a name may hold dots)."""
    path = part(kind, name, '.py')
    mod_name = f'benchmark_torch_{kind}_{name}'.replace('.', '_').replace(
        '-', '_')
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def cell_entry(bench: dict, cell: str) -> dict:
    """The ``workloads`` entry of *cell*; ``KeyError`` if it has none."""
    for entry in bench['workloads']:
        if entry['name'] == cell:
            return entry
    raise KeyError(f'{cell!r} is not a cell of BENCHMARK.json')


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of *section* (``end_to_end`` or ``per_layer``) that
    *cell* reports: those without a ``workloads`` key, and those whose
    ``workloads`` list it."""
    return [m for m in bench[section]
            if 'workloads' not in m or cell in m['workloads']]
