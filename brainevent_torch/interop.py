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

"""Carry a network and its state across from arrays.

The port does not re-implement JAX's random generator, so to simulate the
network the JAX package drew, take its arrays (``np.asarray(net.conn_all)``,
``np.asarray(state.neurons.v)``, ...) and build the port's objects from
them. This module sees numpy arrays only, never a JAX object.
"""

import numpy as np
import torch

from .models.networks import EINet, EINetState
from .models.neurons import LIFRefState

__all__ = ['einet_from_arrays']


def _tensor(x, dtype, device):
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(device)


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
    device : where the network and state live
    kwargs : other :class:`EINet` fields (``dt``, ``w_e``, ...)
    """
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
