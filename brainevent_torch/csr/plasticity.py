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

"""CSR STDP weight updates (``brainevent_tpu.csr.plasticity``).

``update_csr_on_binary_pre``: per entry,
``w[j] += gate(pre_spike[row(j)]) * post_trace[col(j)]``;
``update_csr_on_binary_post``: per entry,
``w[j] += pre_trace[row(j)] * gate(post_spike[col(j)])``. Both clip to
``[w_min, w_max]`` when given. The per-entry product runs through K9
(``ops/pair_gather.py``), materialised in nnz order and then added, as the
JAX package's TPU route does: since the gate is 0 or 1 the product is
exact, so the result also equals its single-expression route bit for bit.
The add and the clip are PyTorch ops.

The AD contract is the JAX package's: the update is the identity with
respect to the weight, and spikes and traces are not differentiated. A
homogeneous ``(1,)`` weight is broadcast to one value per entry first.
The ``weight_indices`` argument of the on-post update is accepted and
unused, as in the JAX package.
"""

from typing import Optional

import torch

from ..ops.pair_gather import pair_gather, pair_gather_product
from ._common import event_gate, row_ids_from_indptr

__all__ = ['update_csr_on_binary_pre', 'update_csr_on_binary_post',
           'update_csc_on_binary_pre', 'update_csc_on_binary_post']


def _update(weight, indices, indptr, pre, post, w_min, w_max):
    """``weight + pre[rows] * post[indices]``, then the clip."""
    indices = torch.as_tensor(indices)
    weight = torch.atleast_1d(torch.as_tensor(weight, device=indices.device))
    if tuple(weight.shape) == (1,):
        weight = weight.expand(indices.shape[0])
    with torch.no_grad():
        rows = row_ids_from_indptr(
            torch.as_tensor(indptr, device=indices.device), indices.shape[0])
        pre = torch.as_tensor(pre, device=indices.device)
        post = torch.as_tensor(post, device=indices.device)
        # float64 weights take K9 in float64 (its double instance on the
        # card), never rounded
        prod = (pair_gather(rows.to(torch.int32).contiguous(),
                            indices.to(torch.int32).contiguous(),
                            pre.double().contiguous(),
                            post.double().contiguous())
                if weight.dtype == torch.float64 else
                pair_gather_product(rows, indices, pre, post))
    out = weight + prod.to(weight.dtype)
    if w_min is not None or w_max is not None:
        out = torch.clamp(out, w_min, w_max)
    return out


def update_csr_on_binary_pre(weight, indices, indptr, pre_spike, post_trace,
                             w_min=None, w_max=None, *, shape,
                             backend: Optional[str] = None):
    """STDP on-pre: add the post traces to every outgoing weight of the
    spiking pre neurons; clip to ``[w_min, w_max]``."""
    del shape, backend
    return _update(weight, indices, indptr, event_gate(pre_spike),
                   post_trace, w_min, w_max)


def update_csr_on_binary_post(weight, indices, indptr, weight_indices,
                              pre_trace, post_spike, w_min=None, w_max=None,
                              *, shape, backend: Optional[str] = None):
    """STDP on-post: add the pre traces to every incoming weight of the
    spiking post neurons; clip to ``[w_min, w_max]``."""
    del weight_indices, shape, backend
    return _update(weight, indices, indptr, pre_trace,
                   event_gate(post_spike), w_min, w_max)


def update_csc_on_binary_pre(weight, indices, indptr, pre_spike, post_trace,
                             w_min=None, w_max=None, *, shape,
                             backend: Optional[str] = None):
    """On-pre update for CSC-stored weights: the columns of the CSC
    structure are the presynaptic rows of the logical matrix."""
    m, k = shape
    return update_csr_on_binary_post(
        weight, indices, indptr, None, post_trace, pre_spike, w_min, w_max,
        shape=(k, m), backend=backend)


def update_csc_on_binary_post(weight, indices, indptr, pre_trace, post_spike,
                              w_min=None, w_max=None, *, shape,
                              backend: Optional[str] = None):
    """On-post update for CSC-stored weights."""
    m, k = shape
    return update_csr_on_binary_pre(
        weight, indices, indptr, post_spike, pre_trace, w_min, w_max,
        shape=(k, m), backend=backend)
