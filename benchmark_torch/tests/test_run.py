"""``run.py`` as the command line runs it: no card, no result."""

import json
import subprocess
import sys

from conftest import ROOT

RUN = [sys.executable, 'benchmark_torch/run.py']


def run(*args, cwd=ROOT):
    return subprocess.run([*RUN, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_refuses_a_host_without_a_card():
    out = run('--workload', 'coba_ei.400k', '--seed', str(2 ** 33),
              '--seconds', '1', '--trace', '0')
    assert out.returncode == 2
    assert out.stdout == ''
    assert 'torch.cuda.is_available() is false' in out.stderr


def test_refuses_an_unknown_cell():
    out = run('--workload', 'no_such_cell', '--seed', '1', '--seconds', '1')
    assert out.returncode not in (0, 2)
    assert out.stdout == ''


def test_imports_neither_jax_nor_the_jax_package():
    code = f'''
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'benchmark_torch' / 'tests')!r})
from _tiny import SEED, TRIALS
from benchmark_torch import run
for cell in ('coba_ei.4k', 'jitc_coba_ei.80k'):
    record = run.measure(cell, SEED, 0.1, True, torch.device('cpu'),
                         time.perf_counter(), traffic=TRIALS)
    assert record['failed'] == 0
print(sorted(m for m in sys.modules if m.split('.')[0] in run.FORBIDDEN))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1].replace("'", '"')) == []
