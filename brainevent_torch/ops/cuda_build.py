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

"""Build the package's CUDA kernels and load them with ctypes.

``nvcc`` compiles every ``brainevent_torch/csrc/*.cu`` into one shared
library with a plain C interface, for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -o <lib> csrc/*.cu

The library is keyed by a hash of the sources and the flags, lives under
``build/brainevent_torch/`` at the root of the checkout (or under
``$BRAINEVENT_TORCH_BUILD_DIR``), and is built at first use: nothing is
compiled when the package is imported. ``-fmad=false`` keeps ``nvcc``
from contracting a multiply and an add into an FMA on its own; each FMA
the kernels need is written out with ``__fmaf_rn``, so the arithmetic
matches the plain PyTorch twins bit for bit.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
caller raises if that is not 0 (see :meth:`brainevent_torch.ops.core.KernelOp.launch`).
There is no fallback when ``nvcc`` is missing or fails.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .._error import CompilationError, KernelLoadError, NvccNotFoundError

__all__ = ['NVCC_FLAGS', 'csrc_dir', 'sources', 'build_dir', 'find_nvcc',
           'build_command', 'library', 'function', 'last_build_seconds']

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_lib = None
_functions = {}
_build_seconds = None


def csrc_dir() -> Path:
    """Directory of the CUDA sources (shipped as package data)."""
    return Path(__file__).resolve().parent.parent / 'csrc'


def sources() -> list:
    """The ``.cu`` files compiled into the library, in a stable order."""
    return sorted(csrc_dir().glob('*.cu'))


def build_dir() -> Path:
    """Where the library is written: ``$BRAINEVENT_TORCH_BUILD_DIR``, else
    ``build/brainevent_torch`` beside the package."""
    env = os.environ.get('BRAINEVENT_TORCH_BUILD_DIR')
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / 'build' / 'brainevent_torch'


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises :class:`NvccNotFoundError` if none exists."""
    candidates = []
    for env in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which('nvcc')
    if found:
        return found
    raise NvccNotFoundError(
        'nvcc was not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin '
        'and PATH). The CUDA kernels of brainevent_torch are compiled at '
        'first use and need the CUDA toolkit.')


def _key() -> str:
    h = hashlib.sha256()
    h.update(' '.join(NVCC_FLAGS).encode())
    for path in sorted(csrc_dir().glob('*.cu*')):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_command(nvcc: str, output, srcs) -> list:
    """The ``nvcc`` command line that builds *output* from *srcs*."""
    return [nvcc, *NVCC_FLAGS, '-o', str(output), *map(str, srcs)]


def _build(path: Path, srcs) -> None:
    global _build_seconds
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    cmd = build_command(find_nvcc(), tmp, srcs)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CompilationError(
            f'nvcc failed (exit {proc.returncode}):\n  {" ".join(cmd)}\n'
            f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    _build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = sources()
            path = build_dir() / f'libbrainevent_torch_{_key()}.so'
            if not path.exists():
                _build(path, srcs)
            try:
                _lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelLoadError(f'cannot load {path}: {e}') from e
        return _lib


def function(name: str, argtypes, restype=ctypes.c_int):
    """C entry point *name* of the library, with its ``argtypes`` set.

    Every pointer and the stream must be ``ctypes.c_void_p`` here: without
    ``argtypes`` ctypes passes a Python int as a 32-bit C int and cuts
    the pointer.
    """
    fn = _functions.get(name)
    if fn is None:
        lib = library()
        try:
            fn = getattr(lib, name)
        except AttributeError as e:
            raise KernelLoadError(f'kernel library lacks {name!r}') from e
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _functions[name] = fn
    return fn


def error_string(code: int) -> str:
    """``cudaGetErrorString`` of *code*, read through the kernel library."""
    fn = function('be_error_string', [ctypes.c_int], ctypes.c_char_p)
    return fn(code).decode()


def last_build_seconds():
    """Seconds the last ``nvcc`` build in this process took (``None``
    when the library was found already built, or not built yet)."""
    return _build_seconds
