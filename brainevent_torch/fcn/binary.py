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

"""Binary fixed-connectivity products. So far only :func:`event_capacity`,
for API parity with ``brainevent_tpu.fcn.binary``: the port's scatters are
atomics and need no static event capacity."""

from .. import config

__all__ = ['event_capacity']


def event_capacity(n: int) -> int:
    """Static active-spike capacity the JAX package's compact event
    scatter uses for ``n`` presynaptic neurons: ``n // divisor`` rounded
    up to a multiple of 8, at least 64 and at most ``n``."""
    div = config.get_event_capacity_divisor()
    cap = max(64, -(-n // div))
    cap = ((cap + 7) // 8) * 8
    return min(n, cap)
