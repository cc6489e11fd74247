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

"""Global configuration for brainevent-torch.

Two pieces of ``brainevent_tpu.config`` carry over:

- the per-device backend map. A tensor on the CPU runs an op's plain
  PyTorch twin (backend ``'torch'``); a tensor on a CUDA device runs the
  op's hand-written kernel (backend ``'cuda'``). There is no fallback from
  one to the other: a CUDA tensor launches its kernel or raises.
- the event-capacity divisor that :func:`brainevent_torch.fcn.event_capacity`
  reads.
"""

import os
from typing import Optional

__all__ = [
    'set_backend', 'get_backend', 'clear_backends', 'backends_for',
    'set_event_capacity_divisor', 'get_event_capacity_divisor',
]

# Backends each device type can run, the first being its default.
_BACKENDS = {
    'cpu': ('torch',),
    'cuda': ('cuda',),
}

_state = {
    'backends': {},  # device type -> backend name
    'event_capacity_divisor': int(
        os.environ.get('BRAINEVENT_EVENT_CAPACITY_DIVISOR', 32)),
}


def _device_type(device_type: str) -> str:
    device_type = str(device_type).lower()
    if device_type == 'gpu':
        device_type = 'cuda'
    return device_type


def backends_for(device_type: str) -> tuple:
    """Return the backends a device type can run (empty if none)."""
    return _BACKENDS.get(_device_type(device_type), ())


def set_backend(device_type: str, backend: Optional[str]) -> None:
    """Set the backend for tensors of *device_type* (``'cpu'`` or
    ``'cuda'``); ``None`` restores the default."""
    device_type = _device_type(device_type)
    if device_type not in _BACKENDS:
        raise ValueError(f'Unknown device type {device_type!r}; expected '
                         f'one of {tuple(_BACKENDS)}.')
    if backend is None:
        _state['backends'].pop(device_type, None)
        return
    if backend not in _BACKENDS[device_type]:
        raise ValueError(f'Backend {backend!r} cannot run {device_type} '
                         f'tensors; expected one of {_BACKENDS[device_type]}.')
    _state['backends'][device_type] = backend


def get_backend(device_type: str) -> Optional[str]:
    """Return the backend for *device_type*: the one set, else the
    default, else ``None`` for a device type no op can run on."""
    device_type = _device_type(device_type)
    if device_type not in _BACKENDS:
        return None
    return _state['backends'].get(device_type, _BACKENDS[device_type][0])


def clear_backends() -> None:
    """Restore every device type's default backend."""
    _state['backends'] = {}


def set_event_capacity_divisor(n: int) -> None:
    """Set the divisor of :func:`brainevent_torch.fcn.event_capacity`."""
    n = int(n)
    if n < 1:
        raise ValueError(f'divisor must be >= 1, got {n}.')
    _state['event_capacity_divisor'] = n


def get_event_capacity_divisor() -> int:
    """Return the event-capacity divisor."""
    return _state['event_capacity_divisor']
