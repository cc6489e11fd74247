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

import numpy as np
import pytest
import torch

import brainevent_torch as bt
from brainevent_torch import config
from brainevent_torch.ops import core, cuda_build
from brainevent_torch.ops import scatter as ts

from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'brainevent_torch'


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import brainevent_torch as bt\n"
        "net = bt.EINet(scale=0.05, device='cpu')\n"
        "bt.einet_pallas_sim(net, net.init_state(), 3)\n"
        "m = bt.SurrogateSNN(n_in=4, n_hidden=64, n_out=2, n_conn=4,\n"
        "                    device='cpu')\n"
        "import torch\n"
        "bt.train_step(m, m.init_params(), torch.rand(3, 4), 1)\n"
        "A = bt.CSR.fromdense(torch.eye(5))\n"
        "A = A.update_on_pre(torch.ones(5) > 0, torch.ones(5))\n"
        "(bt.BinaryArray(torch.ones(5) > 0) @ A, A @ torch.ones(5, 2))\n"
        "D = bt.Dense(torch.eye(5)).update_on_pre(torch.ones(5) > 0,\n"
        "                                         torch.ones(5), -1.0, 1.0)\n"
        "c = bt.CompactBinary.from_array(torch.ones(5, 3) > 0)\n"
        "(D @ c, bt.BinaryArray(torch.ones(5) > 0) @ torch.eye(5),\n"
        " bt.binary_2d_csr_encode_p_call(torch.ones(5, 3)))\n"
        "assert sys.modules['jax'] is None\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brainevent_tpu') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


@pytest.mark.parametrize('path', sorted(PKG.rglob('*.py')) + [
    ROOT / 'scripts' / 'kernel_times.py', ROOT / 'tests' / '_torch_card.py'],
    ids=lambda p: p.name)
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
    # the CSR ops: K7-K10; the dense ops and the row count: K15-K18
    from brainevent_torch.csr import pallas_kernels as pk
    from brainevent_torch.dense import pallas_kernels as dk
    from brainevent_torch.events import pallas_kernels as ek
    from brainevent_torch.ops import mxu_gather as mg
    from brainevent_torch.ops import pair_gather as pg
    for op in (pk.csr_gather_mv, pk.csr_scatter_mv, pg.pair_gather,
               mg.csr_gather_mm, dk.dense_event_mv, dk.dense_event_mm,
               dk.dense_stdp_pre, dk.dense_stdp_post, ek.event_row_count):
        monkeypatch.setattr(op, 'twin', lambda *a, **k: calls.append(a))
    ptr = torch.zeros(3, dtype=torch.int32, device='meta')
    w = torch.zeros(1, device='meta')
    W = torch.zeros(4, 4, device='meta')
    for call in (lambda: pk.csr_gather_mv(ptr, t, None, w, v[0], True),
                 lambda: pk.csr_scatter_mv(ptr, t, None, w, v[0], True, 8),
                 lambda: pg.pair_gather(t, None, v[0], None),
                 lambda: mg.csr_gather_mm(ptr, t, None, w, v.T, False),
                 lambda: dk.dense_event_mv(W, v[0], True),
                 lambda: dk.dense_event_mm(W, W, False),
                 lambda: dk.dense_stdp_pre(W, v[0], v[0], None, None),
                 lambda: dk.dense_stdp_post(W, v[0], v[0], -1.0, 1.0),
                 lambda: ek.event_row_count(W)):
        with pytest.raises(bt.KernelNotAvailableError):
            call()
    assert calls == []


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match='one device'):
        core.tensor_device(torch.zeros(2), torch.zeros(2, device='meta'))


def test_build_command_targets_hopper_without_fma_contraction():
    nvcc = '/usr/local/cuda/bin/nvcc'
    srcs = cuda_build.sources()
    assert {Path(s).name for s in srcs} == {
        'einet_step.cu', 'event_scatter.cu', 'fcn_event.cu', 'plan_gather.cu',
        'csr_event.cu', 'pair_gather.cu', 'csr_gather_mm.cu', 'jitc_walk.cu',
        'dense_event.cu', 'dense_stdp.cu', 'event_encode.cu',
        'einet_dense.cu', 'mega_counts.cu', 'einet_sim.cu', 'einet_shard.cu',
        'mc_sim.cu', 'stdp_sim.cu'}
    for src in srcs:
        cmd = cuda_build.compile_command(nvcc, 'x.o', src)
        assert 'arch=compute_90a,code=sm_90a' in ' '.join(cmd)
        assert '-fmad=false' in cmd and '-O3' in cmd and '-c' in cmd
        assert cmd[-1] == str(src)
    link = cuda_build.link_command(nvcc, 'out.so', ['a.o', 'b.o'])
    assert '-shared' in link and link[-2:] == ['a.o', 'b.o']


def test_build_starts_every_compile_before_waiting(monkeypatch, tmp_path):
    """One nvcc per source, all running at once, then one link."""
    started, waited = [], []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            if '-shared' in cmd:
                Path(cmd[cmd.index('-o') + 1]).write_bytes(b'lib')

        def communicate(self):
            waited.append(len(started))
            return '', None

    monkeypatch.setattr(cuda_build, 'find_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(cuda_build.subprocess, 'Popen', FakeProc)
    srcs = cuda_build.sources()
    out = tmp_path / 'lib.so'
    cuda_build._build(out, srcs)
    assert [c[-1] for c in started[:-1]] == [str(s) for s in srcs]
    assert '-shared' in started[-1]
    assert waited[:len(srcs)] == [len(srcs)] * len(srcs)
    assert out.read_bytes() == b'lib'
    assert list(tmp_path.iterdir()) == [out]


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
    assert shipped == {'common.cuh', 'einet_step.cu', 'event_scatter.cu',
                       'fcn_event.cu', 'plan_gather.cu', 'csr_event.cu',
                       'pair_gather.cu', 'csr_gather_mm.cu', 'light_rng.cuh',
                       'jitc_walk.cu', 'dense_event.cu', 'dense_stdp.cu',
                       'event_encode.cu', 'einet_dense.cu',
                       'mega_counts.cu', 'csr_rows.cuh', 'einet_sim.cu',
                       'einet_neuron.cuh', 'einet_scatter.cuh',
                       'einet_shard.cu', 'mc_sim.cu', 'sim_grid.cuh',
                       'stdp_sim.cu', 'hh_neuron.cuh', 'phase_clock.cuh'}
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
                           'event_scatter_float', 'plan_gather_mv',
                           'plan_matvec_dw', 'fcn_event_scatter',
                           'fcn_event_gather', 'csr_gather_mv',
                           'csr_scatter_mv', 'pair_gather', 'csr_gather_mm',
                           'dense_event_mv', 'dense_event_mm',
                           'dense_stdp_pre', 'dense_stdp_post',
                           'event_row_count', 'einet_dense_hits',
                           'einet_sim', 'einet_sim_hh'}
    bt.reset_launch_counts()
    assert set(bt.launch_counts().values()) == {0}


# kernels of the port's own, which replace no TPU kernel (replaces=None):
# K23, the microcircuit's trial, K24, the HPC benchmark network's, its
# iSTDP instance, Vogels et al. 2011's network's, and K21's HH instance,
# the Hodgkin-Huxley network's, have no counterpart in the JAX package
PORT_ONLY = {'mc_sim', 'stdp_sim', 'istdp_sim', 'einet_sim_hh'}


def _ported():
    """The registry's ops that port a TPU kernel: all but PORT_ONLY, each
    of which says so with ``replaces=None``."""
    assert {op.name for op in core.REGISTRY.values()
            if op.replaces is None} == PORT_ONLY
    return [op for op in core.REGISTRY.values() if op.name not in PORT_ONLY]


def test_registry_names_are_unique_and_document_their_kernel():
    with pytest.raises(bt.KernelRegistrationError):
        bt.KernelOp('einet_step', twin=None, cuda=None, source='', replaces='')
    for op in core.REGISTRY.values():
        assert (ROOT / op.source).is_file()
    for op in _ported():
        path, line = op.replaces.split(':')
        # the float form of K2 and K8 port the JAX package's XLA routes
        if op.name not in ('event_scatter_float', 'csr_scatter_mv'):
            assert 'pallas_call' in (ROOT / path).read_text(), op.name
        assert int(line) > 0


def test_replaces_names_a_def_and_no_line_twice():
    from brainevent_torch.parallel import mega  # noqa: F401 (K20, K22)
    by_line = {}
    for op in _ported():
        path, line = op.replaces.split(':')
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.lstrip().startswith('def '), (op.name, text)
        by_line.setdefault(op.replaces, set()).add(op.name)
    shared = {k: v for k, v in by_line.items() if len(v) > 1}
    # K1 and K2 split one TPU kernel (einet_pallas_sim_mxu3) into the two
    # launches of a step, and K21 runs it whole in one launch; K20 counts
    # the sharded step's partials and K22 runs the step with them in one
    # launch; no other line is named twice
    assert shared == {'brainevent_tpu/models/pallas_sim.py:639': {
        'einet_step', 'event_count_scatter', 'einet_sim'},
        'brainevent_tpu/parallel/mega.py:122': {'mega_counts',
                                                'einet_shard_step'}}
    assert by_line['brainevent_tpu/fcn/pallas_kernels.py:260'] == {
        'fcn_event_scatter'}
    for line, name in (('csr/pallas_kernels.py:55', 'csr_gather_mv'),
                       ('csr/binary.py:57', 'csr_scatter_mv'),
                       ('ops/pair_gather.py:72', 'pair_gather'),
                       ('ops/mxu_gather.py:854', 'csr_gather_mm'),
                       ('dense/binary.py:81', 'dense_event_mv'),
                       ('dense/binary.py:267', 'dense_event_mm'),
                       ('dense/plasticity.py:55', 'dense_stdp_pre'),
                       ('dense/plasticity.py:95', 'dense_stdp_post'),
                       ('events/compact_ops.py:470', 'event_row_count')):
        assert by_line[f'brainevent_tpu/{line}'] == {name}


def _c_params(name):
    """Number of parameters of the C entry point *name* in csrc/."""
    for src in (PKG / 'csrc').glob('*.cu'):
        text = src.read_text()
        key = f' {name}('
        if key in text:
            sig = text[text.index(key) + len(key):]
            return sig[:sig.index(')')].count(',') + 1
    raise AssertionError(f'{name} not found')


def test_wrappers_pass_what_the_c_entry_points_take(monkeypatch):
    """Each CSR, dense and encoder wrapper declares as many ctypes
    arguments as its C entry point has parameters, and passes that many
    (checked without a card: the entry points are replaced by a
    recorder)."""
    from brainevent_torch.csr import pallas_kernels as pk
    from brainevent_torch.dense import pallas_kernels as dk
    from brainevent_torch.events import pallas_kernels as ek
    from brainevent_torch.models import networks as nw
    from brainevent_torch.models import sim
    from brainevent_torch.ops import mxu_gather as mg
    from brainevent_torch.ops import pair_gather as pg
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = len(argtypes)
            return 0
        return fn

    monkeypatch.setattr(cuda_build, 'function', function)
    for mod in (pk, mg, pg, dk, ek, nw):
        monkeypatch.setattr(mod, 'cuda_stream', lambda device: None)
    i32 = torch.int32
    ptr = torch.tensor([0, 2, 3], dtype=i32)
    idx = torch.tensor([0, 1, 1], dtype=i32)
    w, x = torch.ones(3), torch.ones(2)
    plan = mg.plan_from_ell(np.array([[0, 1], [1, 1]]), (2, 2))
    for op, args in ((pk.csr_gather_mv, (ptr, idx, idx, w, x, False)),
                     (mg.plan_gather_mv, (plan, torch.ones(4), x)),
                     (mg.plan_matvec_dw_op, (plan, plan.sort_data(
                         torch.ones(4)), x, x)),
                     (pk.csr_scatter_mv, (ptr, idx, None, w, x > 0, True, 2)),
                     (pg.pair_gather, (idx, idx, x, x)),
                     (mg.csr_gather_mm, (ptr, idx, None, w,
                                         torch.ones(2, 3), False)),
                     (dk.dense_event_mv, (torch.ones(2, 3), x > 0, True)),
                     (dk.dense_event_mm, (torch.ones(2, 3), torch.ones(2, 4),
                                          True)),
                     (dk.dense_stdp_pre, (torch.ones(2, 3), x, w, 0.0, 1.0)),
                     (dk.dense_stdp_post, (torch.ones(3, 2), w, x > 0)),
                     (ek.event_row_count, (torch.ones(2, 3),)),
                     (sim.einet_dense_hits, (idx, idx[:1], torch.zeros(
                         3, 3, dtype=torch.uint8), 2, torch.zeros(
                         2, 3, dtype=i32)))):
        op.cuda(op, *args)
    assert set(seen) == {'csr_gather_mv_launch', 'csr_scatter_mv_launch',
                         'plan_gather_mv_launch', 'plan_matvec_dw_launch',
                         'pair_gather_launch', 'csr_gather_mm_launch',
                         'dense_event_mv_launch', 'dense_event_mm_launch',
                         'dense_stdp_launch', 'event_row_count_launch',
                         'einet_dense_hits_launch'}
    for name, n in seen.items():
        assert _c_params(name) == n, name


def test_params_struct_matches_header():
    from brainevent_torch.models.networks import EINetParams
    header = (PKG / 'csrc' / 'common.cuh').read_text()
    body = header[header.index('struct EINetParams {'):]
    body = body[:body.index('};')]
    fields = [line.split()[1].rstrip(';') for line in body.splitlines()[1:]
              if line.strip() and not line.strip().startswith('//')]
    assert fields == [f for f, _ in EINetParams._fields_]
    assert ctypes.sizeof(EINetParams) == 4 * len(fields)


_NO_DEVICE = {
    'EINet': lambda: bt.EINet(scale=0.05),
    'SurrogateSNN': lambda: bt.SurrogateSNN(n_in=4, n_hidden=64, n_out=2,
                                            n_conn=4),
    'JITCNet': lambda: bt.JITCNet(scale=0.05),
    'HpcStdpNet': lambda: bt.HpcStdpNet(scale=0.001),
    'HHNet': lambda: bt.HHNet(scale=0.05),
    'IstdpNet': lambda: bt.IstdpNet(scale=0.1),
    'lifref_init': lambda: bt.lifref_init(None, 8, bt.LIFRefParams()),
    'einet_from_arrays': lambda: bt.einet_from_arrays(
        np.zeros((200, 4), np.int32), 160, *(np.zeros(200, np.float32),) * 4,
        np.zeros(200, np.int32), scale=0.05, coba=True),
    'surrogate_snn_from_arrays': lambda: bt.surrogate_snn_from_arrays(
        np.zeros((64, 4), np.int32), np.zeros((4, 64), np.float32),
        np.zeros((64, 4), np.float32), np.zeros((64, 2), np.float32)),
    'csr_from_arrays': lambda: bt.csr_from_arrays(
        np.ones(1, np.float32), np.zeros(1, np.int32),
        np.array([0, 1], np.int32), shape=(1, 1)),
    'csc_from_arrays': lambda: bt.csc_from_arrays(
        np.ones(1, np.float32), np.zeros(1, np.int32),
        np.array([0, 1], np.int32), shape=(1, 1)),
    'dense_from_arrays': lambda: bt.dense_from_arrays(
        np.ones((2, 3), np.float32)),
    'jitc_net_from_arrays': lambda: bt.jitc_net_from_arrays(
        *(np.zeros(200, np.float32),) * 4, np.zeros(200, np.int32),
        scale=0.05, weight_law='scalar', coba=True),
    'JITCNormalR': lambda: bt.JITCNormalR((0.6, 0.06, 0.1, 1), shape=(4, 5)),
    'jits': lambda: bt.jits(0.5, 0.1, 1, shape=(4, 5)),
    'neuron_mesh': lambda: __import__(
        'brainevent_torch.parallel', fromlist=['x']).neuron_mesh(),
    'host_chip_mesh': lambda: __import__(
        'brainevent_torch.parallel', fromlist=['x']).host_chip_mesh(),
}


@pytest.mark.parametrize('entry', sorted(_NO_DEVICE))
def test_entry_point_without_device_means_the_card(monkeypatch, entry):
    """With no ``device``, an entry point asks for the card: on a host
    without one it raises, and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = []
    monkeypatch.setattr(core.KernelOp, '__call__',
                        lambda self, *a, **k: calls.append(self.name))
    with pytest.raises(bt.CUDANotInstalledError):
        _NO_DEVICE[entry]()
    assert calls == []


def test_parallel_imports_and_runs_without_jax(tmp_path):
    """``brainevent_torch.parallel`` imports no JAX: with ``jax`` blocked,
    ``import *`` works and a one-rank gloo ShardedEINet runs both
    routes."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from brainevent_torch.parallel import *\n"
        "import torch.distributed as dist\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/pg',"
        " rank=0, world_size=1)\n"
        "mesh = neuron_mesh(device_type='cpu')\n"
        "outs = [ShardedEINet(mesh=mesh, num=400, n_conn=8, propagate=p)"
        ".run(5, inp=40.0).spike_count.to_local() for p in ('scatter', "
        "'mxu6')]\n"
        "assert bool((outs[0] == outs[1]).all()) and int(outs[0].sum()) > 0\n"
        "dist.destroy_process_group()\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brainevent_tpu') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_star_import_names_only_defined_names():
    # the port lists only what it defines; the JAX package's mega lists
    # build_mega_layout, which it does not define (C11)
    import brainevent_torch.parallel as par
    from brainevent_torch.parallel import mega, ops, sharding
    for mod in (par, mega, ops, sharding):
        assert all(hasattr(mod, name) for name in mod.__all__), mod
    scope = {}
    exec('from brainevent_torch.parallel import *', scope)
    assert {'ShardedEINet', 'mega_local_counts', 'sharded_jitmv'} <= set(
        scope)
    with pytest.raises(AttributeError, match='build_mega_layout'):
        exec('from brainevent_tpu.parallel.mega import *', {})


def test_new_wrappers_pass_what_the_c_entry_points_take(monkeypatch):
    """The ELL, JITC walk, K20 and K22 wrappers declare as many ctypes
    arguments as their C entry points have parameters, and pass that
    many (the entry points replaced by a recorder; no card)."""
    from brainevent_torch.fcn import binary as fb
    from brainevent_torch.jitc import pallas_kernels as jk
    from brainevent_torch.parallel import mega
    seen = {}

    def function(name, argtypes, restype=ctypes.c_int):
        def fn(*cargs):
            assert len(cargs) == len(argtypes), name
            seen[name] = len(argtypes)
            return 0
        return fn

    monkeypatch.setattr(cuda_build, 'function', function)
    for mod in (fb, jk, mega):
        monkeypatch.setattr(mod, 'cuda_stream', lambda device: None)
    i32 = torch.int32
    idx = torch.zeros(4, 3, dtype=i32)
    s = torch.ones(4) > 0
    for w in (torch.ones(1), torch.ones(4, 3, dtype=torch.float64)):
        fb.fcn_event_scatter.cuda(fb.fcn_event_scatter, w, idx, s, 5)
        fb.fcn_event_gather.cuda(fb.fcn_event_gather, w, idx, s, 5)
    st = torch.zeros(4, 2 * 32, dtype=i32)
    jk.jitc_walk_setup.cuda(jk.jitc_walk_setup, st, st.clone(), seed=1,
                            cl=2, n_rows=4, n_cols=6, chunk_size=3,
                            stride=32, row0=8)
    jk.jitc_walk_mv.cuda(jk.jitc_walk_mv, None, None, torch.ones(6),
                         law=1, a=0.5, b=0.1, seed=1, cl=2, n_rows=4,
                         n_cols=6, logical_cols=6, corder=True, event=False,
                         row0=8)
    mega.mega_counts.cuda(mega.mega_counts, torch.zeros(4, dtype=i32),
                          torch.zeros(1, dtype=i32), idx, 4, 3,
                          torch.zeros(2, 2, 3, dtype=i32))
    from brainevent_torch.models.networks import EINetParams
    state = [torch.zeros(4) for _ in range(4)]
    mega.einet_shard_step.cuda(
        mega.einet_shard_step, *state, torch.zeros(2, 4, dtype=i32),
        torch.zeros(4, dtype=i32), torch.zeros(2, 2, 2, 4, dtype=i32), idx,
        4, 3, EINetParams(num=4), 0.0, 1, True, True)
    with pytest.raises(ValueError, match='n_loc=4'):
        mega.einet_shard_step.cuda(
            mega.einet_shard_step, *state, torch.zeros(2, 4, dtype=i32),
            torch.zeros(4, dtype=i32), torch.zeros(2, 2, 4, dtype=i32), idx,
            4, 3, EINetParams(num=4), 0.0, 1, True, True)
    assert set(seen) == {'fcn_event_scatter_launch',
                         'fcn_event_gather_launch', 'jitc_walk_setup_launch',
                         'jitc_walk_mv_launch', 'mega_counts_launch',
                         'einet_shard_step_launch'}
    for name, n in seen.items():
        assert _c_params(name) == n, name
