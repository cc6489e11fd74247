# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""Packaging and dispatch of brainevent_torch: no JAX, the CUDA build
command, the op registry and its device checks."""

import ast
import ctypes
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

import brainevent_torch as bt
from brainevent_torch import config
from brainevent_torch.ops import core, cuda_build
from brainevent_torch.ops import scatter as ts

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'brainevent_torch'


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import brainevent_torch as bt\n"
        "net = bt.EINet(scale=0.05)\n"
        "bt.einet_pallas_sim(net, net.init_state(), 3)\n"
        "assert sys.modules['jax'] is None\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brainevent_tpu') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py')) +
                         [ROOT / 'chip_smoke.py'], ids=lambda p: p.name)
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in ('jax', 'jaxlib',
                                              'brainevent_tpu'), (path, name)


def test_cuda_request_raises_without_running_twin(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = []
    monkeypatch.setattr(ts.event_scatter_float, 'twin',
                        lambda *a, **k: calls.append(a))
    with pytest.raises(bt.CUDANotInstalledError):
        core.check_device('cuda')
    with pytest.raises(bt.CUDANotInstalledError):
        bt.EINet(scale=0.05, device='cuda:0')
    # a device no backend serves raises too, and runs no twin
    t = torch.zeros(4, dtype=torch.int32, device='meta')
    v = torch.zeros(1, 4, device='meta')
    with pytest.raises(bt.KernelNotAvailableError):
        ts.event_scatter_float(t, v, torch.zeros(1, 8, device='meta'))
    assert calls == []


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match='one device'):
        core.tensor_device(torch.zeros(2), torch.zeros(2, device='meta'))


def test_build_command_targets_hopper_without_fma_contraction():
    cmd = cuda_build.build_command('/usr/local/cuda/bin/nvcc', 'out.so',
                                   cuda_build.sources())
    joined = ' '.join(cmd)
    assert 'arch=compute_90a,code=sm_90a' in joined
    assert '-fmad=false' in cmd and '-shared' in cmd and '-O3' in cmd
    assert {Path(s).name for s in cmd if s.endswith('.cu')} == {
        'einet_step.cu', 'event_scatter.cu'}


def test_build_dir_is_under_build(monkeypatch):
    monkeypatch.delenv('BRAINEVENT_TORCH_BUILD_DIR', raising=False)
    assert cuda_build.build_dir() == ROOT / 'build' / 'brainevent_torch'
    monkeypatch.setenv('BRAINEVENT_TORCH_BUILD_DIR', '/x/y')
    assert cuda_build.build_dir() == Path('/x/y')


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(cuda_build, 'Path', _NoUsrLocal)
    with pytest.raises(bt.NvccNotFoundError, match='nvcc'):
        cuda_build.find_nvcc()


class _NoUsrLocal(type(Path())):
    def is_file(self):
        return False if str(self).startswith('/usr/local') else super().is_file()


def test_cu_sources_ship_as_package_data():
    cfg = tomllib.loads((ROOT / 'pyproject.toml').read_text())
    tool = cfg['tool']['setuptools']
    assert 'brainevent_torch*' in tool['packages']['find']['include']
    data = tool['package-data']['brainevent_torch']
    assert set(data) == {'csrc/*.cu', 'csrc/*.cuh'}
    shipped = {p.name for pat in data for p in PKG.glob(pat)}
    assert shipped == {'common.cuh', 'einet_step.cu', 'event_scatter.cu'}
    assert cfg['project']['optional-dependencies']['torch'] == ['torch']


def test_backend_map_defaults_and_validation():
    try:
        assert config.get_backend('cpu') == 'torch'
        assert config.get_backend('cuda') == config.get_backend('gpu') == 'cuda'
        assert config.get_backend('meta') is None
        with pytest.raises(ValueError):
            config.set_backend('cuda', 'torch')     # no twin on a CUDA tensor
        with pytest.raises(ValueError):
            config.set_backend('tpu', 'torch')
        config.set_backend('cuda', 'cuda')
        assert config.get_backend('cuda') == 'cuda'
        config.set_backend('cuda', None)
        assert config.get_backend('cuda') == 'cuda'
    finally:
        config.clear_backends()


def test_launch_counts_only_successful_launches(monkeypatch):
    op = ts.event_scatter_float
    before = op.launches
    op.launch(lambda *a: 0, 1, 2)
    assert op.launches == before + 1
    monkeypatch.setattr(cuda_build, 'error_string', lambda code: 'refused')
    with pytest.raises(bt.KernelExecutionError, match='refused'):
        op.launch(lambda *a: 9)
    assert op.launches == before + 1
    counts = bt.launch_counts()
    assert set(counts) >= {'einet_step', 'event_count_scatter',
                           'event_scatter_float'}
    bt.reset_launch_counts()
    assert set(bt.launch_counts().values()) == {0}


def test_registry_names_are_unique_and_document_their_kernel():
    with pytest.raises(bt.KernelRegistrationError):
        bt.KernelOp('einet_step', twin=None, cuda=None, source='', replaces='')
    for op in core.REGISTRY.values():
        assert (ROOT / op.source).is_file()
        path, line = op.replaces.split(':')
        assert 'pallas_call' in (ROOT / path).read_text() and int(line) > 0


def test_params_struct_matches_header():
    from brainevent_torch.models.networks import EINetParams
    header = (PKG / 'csrc' / 'common.cuh').read_text()
    body = header[header.index('struct EINetParams {'):]
    body = body[:body.index('};')]
    fields = [line.split()[1].rstrip(';') for line in body.splitlines()[1:]
              if line.strip() and not line.strip().startswith('//')]
    assert fields == [f for f, _ in EINetParams._fields_]
    assert ctypes.sizeof(EINetParams) == 4 * len(fields)
