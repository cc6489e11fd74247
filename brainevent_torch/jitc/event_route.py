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

"""Event scatter products over a walk plan
(``brainevent_tpu.jitc.event_route``).

On the TPU a branch per stream is not available, so the JAX package
compacts the active rows to a static capacity, walks their streams for a
static number of rounds, and falls back to the full product when either
bound is exceeded. On the card the route is one K12 launch in event
scatter mode: a stream whose row did not spike leaves before its first
draw (the reference CUDA's early-out), and every live stream walks to the
end of its chunk, so no bound exists and no fallback is needed.
``scan_rounds``, ``cap``, ``row_cap`` and ``fallback`` are accepted and
ignored, as the other TPU layout knobs are: the port has no event-route
knobs.
"""

from typing import Optional

from .pallas_kernels import jitc_walk_mv

__all__ = ['jitc_event_matvec_plan']


def jitc_event_matvec_plan(law: int, a: float, b: float, seed: int, v,
                           out_len: int, *, n_rows: int, logical_cols: int,
                           setup, scan_rounds: Optional[int] = None,
                           cap: Optional[int] = None, fallback=None,
                           row_cap: Optional[int] = None):
    """``out[col] += w(row, col)`` over the rows with ``v > 0`` (or true):
    one K12 launch over the plan ``setup = (state2, q2, cl)`` of the
    scatter-direction walk (``n_rows`` walk rows, ``out_len`` walk
    columns)."""
    del scan_rounds, cap, fallback, row_cap
    state2, q2, cl = setup
    return jitc_walk_mv(state2, q2, v, law=law, a=a, b=b, seed=seed, cl=cl,
                        n_rows=n_rows, n_cols=out_len,
                        logical_cols=logical_cols, corder=False, event=True)
