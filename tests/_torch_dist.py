# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The worker side of the gloo tests of ``brainevent_torch.parallel``.

A test computes the JAX side on its 8-device virtual CPU mesh, then calls
:func:`spawn`, which starts ``world`` CPU processes
(``torch.multiprocessing.spawn``) that join one gloo process group through
a file under the test's temporary directory (so parallel test workers
never share a port), run one task of this module on the same numpy
inputs, and leave rank 0's results in an ``.npz`` that :func:`spawn`
returns. The inputs are made here, from seeds, so that the test process
builds the same arrays for the JAX side. This module imports ``torch``,
``numpy`` and ``brainevent_torch`` only.
"""

import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# every collective of torch.distributed a step could call
COLLECTIVES = ('all_reduce', 'reduce_scatter_tensor', 'reduce_scatter',
               'reduce_scatter_single', 'all_gather_into_tensor',
               'all_gather', 'all_gather_single', 'broadcast', 'reduce',
               'all_to_all', 'all_to_all_single', 'send', 'recv', 'barrier')

EINET_STEPS = 80
MXU6_STEPS, MXU6_RUN_STEPS = 15, 40


def spawn(task: str, world: int, tmp) -> dict:
    """Run *task* on *world* gloo ranks; rank 0's results."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / 'pg').unlink(missing_ok=True)     # the file store starts empty
    mp.spawn(_worker, args=(world, task, str(tmp)), nprocs=world, join=True)
    with np.load(tmp / 'out.npz') as f:
        return dict(f)


def _worker(rank, world, task, tmp):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{tmp}/pg',
                            rank=rank, world_size=world)
    try:
        out = TASKS[task](tmp)
        if rank == 0:
            np.savez(os.path.join(tmp, 'out.npz'), **out)
    finally:
        dist.destroy_process_group()


class CollectiveLog:
    """Counts the calls of :data:`COLLECTIVES` on ``torch.distributed``
    while it is entered, with the bytes of each call's input."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = {n: getattr(dist, n) for n in COLLECTIVES
                      if hasattr(dist, n)}
        for name, fn in self.saved.items():
            setattr(dist, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            src = tensors[1] if len(tensors) > 1 else (tensors or [None])[0]
            n_bytes = 0 if src is None else src.numel() * src.element_size()
            self.calls.append((name, n_bytes))
            return fn(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def _np(x):
    if hasattr(x, 'full_tensor'):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


# -- inputs (numpy, from seeds) ------------------------------------------------------

def fcn_inputs(seed, n_pre, n_post, n_conn, hetero):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, n_post, (n_pre, n_conn)).astype(np.int32)
    w = (rng.normal(size=(n_pre, n_conn)).astype(np.float32) if hetero
         else np.array([0.5], np.float32))
    return w, indices, rng


def csr_inputs(seed, m, k, hetero):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 10, m)
    nse = int(counts.sum())
    indices = rng.integers(0, k, nse).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    w = (rng.normal(size=nse).astype(np.float32) if hetero
         else np.array([0.5], np.float32))
    return w, indices, indptr, rng


def ops_cases() -> dict:
    """``name -> (kind, arguments)`` of the sharded-op cases, the inputs
    made from seeds; the same in the test process and in the workers."""
    cases = {}
    seed = 100
    for hetero in (False, True):
        for transpose in (True, False):
            w, idx, rng = fcn_inputs(seed, 250, 300, 8, hetero)
            spk = rng.random(250 if transpose else 300) < 0.15
            cases[f'fcnmv_{"hetero" if hetero else "homo"}_'
                  f'{"T" if transpose else "N"}'] = ('fcn', dict(
                      w=w, indices=idx, x=spk, shape=(250, 300),
                      transpose=transpose, reduce='psum'))
            seed += 1
    w, idx, rng = fcn_inputs(seed, 256, 256, 8, True)
    cases['fcnmv_psum_scatter'] = ('fcn', dict(
        w=w, indices=idx, x=rng.random(256) < 0.1, shape=(256, 256),
        transpose=True, reduce='psum_scatter'))
    for binary, mm in ((True, False), (False, False), (True, True),
                       (False, True)):
        for hetero in ((False, True) if binary and not mm else (True,)):
            for transpose in (True, False):
                seed += 1
                m, k = (130, 140) if mm else (250, 300)
                w, idx, ptr, rng = csr_inputs(seed, m, k, hetero)
                n = m if transpose else k
                x = ((rng.random((n, 3) if mm else n) < 0.2) if binary
                     else rng.normal(size=(n, 3) if mm else n).astype(
                         np.float32))
                name = (f'{"binary_" if binary else ""}csr'
                        f'{"mm" if mm else "mv"}'
                        f'{"_hetero" if binary and not mm and hetero else ""}'
                        f'{"_homo" if binary and not mm and not hetero else ""}'
                        f'_{"T" if transpose else "N"}')
                cases[name] = ('csr', dict(
                    w=w, indices=idx, indptr=ptr, x=x, shape=(m, k),
                    transpose=transpose, binary=binary, mm=mm,
                    reduce='psum'))
    w, idx, ptr, rng = csr_inputs(seed + 1, 256, 300, True)
    cases['binary_csrmv_psum_scatter'] = ('csr', dict(
        w=w, indices=idx, indptr=ptr, x=rng.random(256) < 0.15,
        shape=(256, 300), transpose=True, binary=True, mm=False,
        reduce='psum_scatter'))
    w, idx, ptr, rng = csr_inputs(seed + 2, 250, 300, True)
    cases['csr_weight_grad'] = ('csr_grad', dict(
        w=w, indices=idx, indptr=ptr, x=rng.random(250) < 0.15,
        cot=rng.normal(size=300).astype(np.float32), shape=(250, 300),
        axis=None))
    rng = np.random.default_rng(seed + 3)
    for law, params in (('s', (1.5,)), ('n', (0.5, 0.2)), ('u', (0.1, 0.9))):
        cases[f'jitmv_{law}_corder'] = ('jit', dict(
            law=law, params=params, x=rng.normal(size=200).astype(
                np.float32), shape=(264, 200), corder=True, event=False,
            transpose=False))
    cases['jitmv_n_scatter'] = ('jit', dict(
        law='n', params=(0.5, 0.2), x=rng.normal(size=180).astype(
            np.float32), shape=(240, 180), corder=False, event=False,
        transpose=False))
    cases['jitmv_n_event'] = ('jit', dict(
        law='n', params=(0.5, 0.2), x=rng.random(96) < 0.3, shape=(128, 96),
        corder=True, event=True, transpose=False))
    for corder in (True, False):
        cases[f'jitmv_n_transpose_{"corder" if corder else "scatter"}'] = (
            'jit', dict(law='n', params=(0.5, 0.2),
                        x=rng.normal(size=264).astype(np.float32),
                        shape=(264, 200), corder=corder, event=False,
                        transpose=True))
    # the 2-D (hosts, chips) mesh
    w, idx, rng = fcn_inputs(seed + 4, 250, 300, 8, True)
    cases['mesh2_fcnmv_both_axes'] = ('fcn', dict(
        w=w, indices=idx, x=rng.random(250) < 0.15, shape=(250, 300),
        transpose=True, reduce='psum', axis=('hosts', 'chips')))
    for axis in ('hosts', 'chips'):
        w, idx, rng = fcn_inputs(seed + 5, 64, 256, 4, False)
        cases[f'mesh2_fcnmv_{axis}'] = ('fcn', dict(
            w=w, indices=idx, x=rng.random(64) < 0.2, shape=(64, 256),
            transpose=True, reduce='psum', axis=axis))
    w, idx, ptr, rng = csr_inputs(seed + 6, 250, 304, True)
    cases['mesh2_csr_weight_grad_both_axes'] = ('csr_grad', dict(
        w=w, indices=idx, indptr=ptr, x=rng.random(250) < 0.15,
        cot=rng.normal(size=304).astype(np.float32), shape=(250, 304),
        axis=('hosts', 'chips')))
    return cases


# -- tasks ---------------------------------------------------------------------------

def _meshes():
    from brainevent_torch.parallel import host_chip_mesh, neuron_mesh
    return (neuron_mesh(device_type='cpu'),
            host_chip_mesh(2, 2, device_type='cpu'))


def _run_case(kind, a, mesh1, mesh2):
    from brainevent_torch import parallel as par
    axis = a.get('axis')
    mesh = mesh2 if axis is not None else mesh1
    if kind == 'fcn':
        return _np(par.sharded_binary_fcnmv(
            torch.from_numpy(a['w']), torch.from_numpy(a['indices']),
            torch.from_numpy(a['x']), mesh=mesh, shape=a['shape'],
            transpose=a['transpose'], axis=axis, reduce=a['reduce']))
    if kind == 'csr':
        fn = {(True, False): par.sharded_binary_csrmv,
              (False, False): par.sharded_csrmv,
              (True, True): par.sharded_binary_csrmm,
              (False, True): par.sharded_csrmm}[(a['binary'], a['mm'])]
        return _np(fn(torch.from_numpy(a['w']),
                      torch.from_numpy(a['indices']),
                      torch.from_numpy(a['indptr']),
                      torch.from_numpy(a['x']), mesh=mesh, shape=a['shape'],
                      transpose=a['transpose'], reduce=a['reduce']))
    if kind == 'csr_grad':
        plan = par.balance_csr_shards(a['indices'], a['indptr'],
                                      4, shape=a['shape'])
        w = torch.from_numpy(a['w']).requires_grad_(True)
        y = par.sharded_binary_csrmv(
            w, torch.from_numpy(a['indices']), torch.from_numpy(a['indptr']),
            torch.from_numpy(a['x']), mesh=mesh, shape=a['shape'], axis=axis,
            plan=plan)
        (y.full_tensor() * torch.from_numpy(a['cot'])).sum().backward()
        return _np(w.grad)
    return _np(par.sharded_jitmv(
        a['law'], a['params'], 0.1, torch.from_numpy(a['x']), 7, mesh=mesh,
        shape=a['shape'], corder=a['corder'], event=a['event'],
        transpose=a['transpose']))


def ops_task(tmp) -> dict:
    """Every case of :func:`ops_cases` through the port's sharded ops,
    plus the refusals: ``psum_scatter``'s divisibility guard, and a
    backward through ``sharded_binary_fcnmv`` (no float ELL products)."""
    import brainevent_torch as bt
    from brainevent_torch import parallel as par
    mesh1, mesh2 = _meshes()
    out = {name: _run_case(kind, a, mesh1, mesh2)
           for name, (kind, a) in ops_cases().items()}
    w, idx, ptr, _ = csr_inputs(7, 256, 300, False)
    try:
        par.sharded_binary_csrmv(torch.from_numpy(w), torch.from_numpy(idx),
                                 torch.from_numpy(ptr),
                                 torch.zeros(256, dtype=torch.bool),
                                 mesh=mesh2, shape=(256, 302),
                                 axis=('hosts', 'chips'),
                                 reduce='psum_scatter')
        out['guard_psum_scatter'] = np.array(False)
    except ValueError as err:
        out['guard_psum_scatter'] = np.array('divisible' in str(err))
    w, idx, rng = fcn_inputs(8, 250, 300, 8, True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = par.sharded_binary_fcnmv(wt, torch.from_numpy(idx),
                                 torch.from_numpy(rng.random(250) < 0.2),
                                 mesh=mesh1, shape=(250, 300))
    try:
        y.full_tensor().sum().backward()
        out['fcn_backward_raises'] = np.array(False)
    except bt.UnsupportedOperationError:
        out['fcn_backward_raises'] = np.array(True)
    return out


# -- the sharded EI network ---------------------------------------------------------------

def einet_inputs(seed, num, n_exc, n_conn, deg=None):
    """A table (optionally with one target of in-degree *deg* among the
    excitatory rows) and an initial state, from *seed*."""
    rng = np.random.default_rng(seed)
    conn = rng.integers(0, num, (num, n_conn)).astype(np.int32)
    if deg is not None:
        conn[:deg, 0] = 5
    v = (-55.0 + 2.0 * rng.normal(size=num)).astype(np.float32)
    return conn, v


def _state_np(state):
    return {k: _np(getattr(state, k))
            for k in ('v', 't_last', 'g_e', 'g_i', 'spike_count')}


def einet_task(tmp) -> dict:
    """The port's ShardedEINet on the JAX arrays of the test process
    (``jax_in.npz`` in *tmp*), both routes, at world size 4, with its collectives
    counted; and the mxu6 route against the scatter route at a shard width
    that is not a multiple of 128 and at an in-degree of 300."""
    from brainevent_torch.interop import sharded_einet_from_arrays
    from brainevent_torch.parallel import ShardedEINet, neuron_mesh
    mesh = neuron_mesh(device_type='cpu')
    out = {}
    with np.load(os.path.join(tmp, 'jax_in.npz')) as f:
        arrays = dict(f)
    for label in ('coba', 'cuba', 'mxu6_step', 'mxu6_run'):
        a = {k[len(label) + 1:]: v for k, v in arrays.items()
             if k.startswith(label + ':')}
        propagate = 'mxu6' if label.startswith('mxu6') else 'scatter'
        net, state = sharded_einet_from_arrays(
            a['indices'], int(a['n_exc']), a['v'], a['t_last'], a['g_e'],
            a['g_i'], a['spike_count'], mesh=mesh, propagate=propagate,
            coba=bool(a['coba']))
        with CollectiveLog() as log:
            if label == 'mxu6_step':
                step = net.step_fn()
                for i in range(MXU6_STEPS):
                    state = step(state, i * 0.1)
            else:
                n = MXU6_RUN_STEPS if label == 'mxu6_run' else EINET_STEPS
                state = net.run(n, state=state)
        for k, v in _state_np(state).items():
            out[f'{label}:{k}'] = v
        out[f'{label}:calls'] = np.array([c[0] for c in log.calls])
        out[f'{label}:bytes'] = np.array([c[1] for c in log.calls])
    # mxu6 where JAX refuses it, against the scatter route
    for label, num, n_conn, deg in (('unaligned', 4 * 64, 8, None),
                                    ('indegree300', 512, 16, 300)):
        conn, v = einet_inputs(11, num, int(num * 0.8), n_conn, deg)
        res = {}
        for propagate in ('scatter', 'mxu6'):
            net = ShardedEINet(mesh=mesh, num=num, n_conn=n_conn,
                               indices=torch.from_numpy(conn),
                               propagate=propagate)
            zeros = np.zeros(num, np.float32)
            state = net.shard_state(v, np.full(num, -1e7, np.float32), zeros,
                                    zeros, np.zeros(num, np.int32))
            res[propagate] = _state_np(net.run(30, inp=30.0, state=state))
        for k in res['scatter']:
            out[f'{label}:{k}:scatter'] = res['scatter'][k]
            out[f'{label}:{k}:mxu6'] = res['mxu6'][k]
    return out


TASKS = {'ops': ops_task, 'einet': einet_task}
