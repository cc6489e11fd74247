# Copyright 2026 The brainevent-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
# ==============================================================================

"""Carry a network, its state or a sparse matrix across from arrays.

The port does not re-implement JAX's random generator, so to simulate the
network the JAX package drew, take its arrays (``np.asarray(net.conn_all)``,
``np.asarray(state.neurons.v)``, ``np.asarray(model.rec_indices)``,
``np.asarray(csr.data)``, ``np.asarray(dense.data)``, ...) and build the
port's objects from them.
This module sees numpy arrays only, never a JAX object.
"""

import numpy as np
import torch

from .csr.main import CSC, CSR
from .dense.main import Dense
from .models.jitc_net import JITCNet, JITCNetState
from .models.networks import EINet, EINetState
from .models.neurons import LIFRefState
from .models.training import SNNParams, SurrogateSNN
from .ops.core import check_device

__all__ = ['einet_from_arrays', 'surrogate_snn_from_arrays',
           'csr_from_arrays', 'csc_from_arrays', 'dense_from_arrays',
           'jitc_net_from_arrays', 'sharded_einet_from_arrays']


def _tensor(x, dtype, device):
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(device)


def _device(device) -> torch.device:
    """*device*, default the card; raises without one."""
    return check_device(device or 'cuda')


def einet_from_arrays(conn_all, n_exc, v, t_last, g_e, g_i, spike_count, *,
                      scale: float, coba: bool, device=None, **kwargs):
    """Build the port's ``(EINet, EINetState)`` from numpy arrays.

    Parameters
    ----------
    conn_all : ``(num, n_conn)`` int array, excitatory rows first
    n_exc : int, checked against ``int(3200 * scale)``
    v, t_last, g_e, g_i : ``(num,)`` float arrays
    spike_count : ``(num,)`` int array
    scale, coba : as :class:`EINet`
    device : where the network and state live (default the card)
    kwargs : other :class:`EINet` fields (``dt``, ``w_e``, ...)
    """
    device = _device(device)
    conn = np.asarray(conn_all)
    f = np.float32
    state = EINetState(
        neurons=LIFRefState(v=_tensor(v, f, device),
                            t_last=_tensor(t_last, f, device)),
        g_e=_tensor(g_e, f, device), g_i=_tensor(g_i, f, device),
        spike_count=_tensor(spike_count, np.int32, device))
    net = EINet(scale=scale, coba=coba, n_conn=conn.shape[1],
                conn_all=torch.from_numpy(conn.astype(np.int32)),
                initial_state=state, device=device, **kwargs)
    if net.n_exc != int(n_exc) or state.neurons.v.shape != (net.num,):
        raise ValueError(
            f'arrays do not fit scale={scale}: n_exc {n_exc} vs {net.n_exc}, '
            f'v {tuple(state.neurons.v.shape)} vs ({net.num},)')
    return net, state


def surrogate_snn_from_arrays(rec_indices, w_in, w_rec, w_out, *,
                              device=None, **fields):
    """Build the port's ``(SurrogateSNN, SNNParams)`` from numpy arrays.

    Parameters
    ----------
    rec_indices : ``(n_hidden, n_conn)`` int array, the recurrent ELL table
    w_in : ``(n_in, n_hidden)`` float array
    w_rec : ``(n_hidden, n_conn)`` float array
    w_out : ``(n_hidden, n_out)`` float array
    device : where the model and parameters live (default the card)
    fields : other :class:`SurrogateSNN` fields (``tau``, ``dt``, ``v_th``,
        ``forward``, ...); the sizes come from the arrays' shapes.
    """
    device = _device(device)
    idx = np.asarray(rec_indices)
    f = np.float32
    params = SNNParams(w_in=_tensor(w_in, f, device),
                       w_rec=_tensor(w_rec, f, device),
                       w_out=_tensor(w_out, f, device))
    n_in, n_hidden = params.w_in.shape
    if (params.w_rec.shape != idx.shape
            or params.w_out.shape[0] != n_hidden):
        raise ValueError(
            f'arrays do not fit: rec_indices {idx.shape}, w_in '
            f'{tuple(params.w_in.shape)}, w_rec {tuple(params.w_rec.shape)}, '
            f'w_out {tuple(params.w_out.shape)}')
    model = SurrogateSNN(
        n_in=n_in, n_hidden=n_hidden, n_out=params.w_out.shape[1],
        n_conn=idx.shape[1], device=device,
        rec_indices=torch.from_numpy(idx.astype(np.int32)),
        initial_params=params, **fields)
    return model, params


def csr_from_arrays(data, indices, indptr, *, shape, device=None) -> CSR:
    """The port's :class:`~brainevent_torch.CSR` from a CSR matrix's arrays
    (``data`` ``(1,)`` or ``(nse,)``, float32; ``indices``, ``indptr``
    int32), on *device*."""
    device = _device(device)
    return CSR((_tensor(np.atleast_1d(data), np.float32, device),
                _tensor(indices, np.int32, device),
                _tensor(indptr, np.int32, device)), shape=tuple(shape))


def csc_from_arrays(data, indices, indptr, *, shape, device=None) -> CSC:
    """The port's :class:`~brainevent_torch.CSC` from a CSC matrix's arrays
    (the CSR arrays of its transpose; ``shape`` is the logical one)."""
    device = _device(device)
    return CSC((_tensor(np.atleast_1d(data), np.float32, device),
                _tensor(indices, np.int32, device),
                _tensor(indptr, np.int32, device)), shape=tuple(shape))


def dense_from_arrays(w, *, device=None) -> Dense:
    """The port's :class:`~brainevent_torch.Dense` from a dense weight
    matrix (``np.asarray(dense.data)``, float32), on *device* (default the
    card)."""
    return Dense(_tensor(w, np.float32, _device(device)))


def jitc_net_from_arrays(v, t_last, g_e, g_i, spike_count, *, scale: float,
                         weight_law: str, coba: bool, seed: int = 42,
                         device=None, **fields):
    """Build the port's ``(JITCNet, JITCNetState)`` from a state's numpy
    arrays. The connectivity needs no carrying: it regenerates from the
    weight law's parameters, ``prob`` and ``seed``.

    Parameters
    ----------
    v, t_last, g_e, g_i : ``(num,)`` float arrays
    spike_count : ``(num,)`` int array
    scale, weight_law, coba, seed : as :class:`JITCNet`
    device : where the network and state live (default the card)
    fields : other :class:`JITCNet` fields (``dt``, ``w_e``, ...)
    """
    device = _device(device)
    f = np.float32
    state = JITCNetState(
        neurons=LIFRefState(v=_tensor(v, f, device),
                            t_last=_tensor(t_last, f, device)),
        g_e=_tensor(g_e, f, device), g_i=_tensor(g_i, f, device),
        spike_count=_tensor(spike_count, np.int32, device))
    net = JITCNet(scale=scale, weight_law=weight_law, coba=coba, seed=seed,
                  initial_state=state, device=device, **fields)
    if state.neurons.v.shape != (net.num,):
        raise ValueError(f'arrays do not fit scale={scale}: v '
                         f'{tuple(state.neurons.v.shape)} vs ({net.num},)')
    return net, state


def sharded_einet_from_arrays(indices, n_exc, v, t_last, g_e, g_i,
                              spike_count, *, mesh, propagate='scatter',
                              **params):
    """Build the port's ``(ShardedEINet, ShardedEINetState)`` from the
    global numpy arrays of the JAX ``ShardedEINet`` (``np.asarray(
    net.indices)``, ``np.asarray(state.v)``, ...). Every rank passes the
    same arrays and keeps its block of neurons, its rows of *indices* and
    its block of the state, on the mesh's device.

    Parameters
    ----------
    indices : ``(num, n_conn)`` int array, excitatory rows first
    n_exc : int, checked against ``int(num * exc_fraction)``
    v, t_last, g_e, g_i : ``(num,)`` float arrays
    spike_count : ``(num,)`` int array
    mesh : the ``DeviceMesh`` to shard over (its first dimension)
    propagate : ``'scatter'`` or ``'mxu6'``, as :class:`ShardedEINet`
    params : other :class:`ShardedEINet` fields (``coba``, ``dt``, ``w_e``,
        ...); ``exc_fraction`` defaults to ``n_exc / num``.
    """
    from .parallel import ShardedEINet
    idx = np.asarray(indices).astype(np.int32)
    num = idx.shape[0]
    params.setdefault('exc_fraction', int(n_exc) / num)
    net = ShardedEINet(mesh=mesh, num=num, n_conn=idx.shape[1],
                       indices=torch.from_numpy(idx), propagate=propagate,
                       **params)
    if net.n_exc != int(n_exc):
        raise ValueError(f'n_exc {n_exc} does not fit num={num} and '
                         f'exc_fraction={net.exc_fraction} ({net.n_exc})')
    state = net.shard_state(np.asarray(v, np.float32),
                            np.asarray(t_last, np.float32),
                            np.asarray(g_e, np.float32),
                            np.asarray(g_i, np.float32),
                            np.asarray(spike_count, np.int32))
    return net, state
