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

"""brainevent-torch: event-driven spiking-network simulation in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``brainevent_tpu`` (JAX/Pallas), module for module and under
the same names. It imports ``torch`` and ``numpy``, never ``jax``. Each op
has a plain PyTorch twin, which runs for CPU tensors, and a CUDA kernel,
which runs for CUDA tensors; the kernels are compiled by ``nvcc`` at first
use (:mod:`brainevent_torch.ops.cuda_build`). Entry points that create
tensors (``EINet``, ``JITCNet``, ``SurrogateSNN``, the JITC matrices, the
``interop`` builders, ``dense_from_arrays`` among them) place them on the
card unless given ``device='cpu'``.
"""

from ._version import __version__, __version_info__
from . import config
from ._error import (
    BrainEventError, MathError, UnsupportedOperationError, KernelError,
    KernelNotAvailableError, KernelCompilationError, CompilationError,
    KernelExecutionError, CUDANotInstalledError, KernelToolchainError,
    NvccNotFoundError, KernelLoadError, KernelRegistrationError,
)
from .fcn import binary_fcnmv, binary_fcnmv_p_call, event_capacity
from .ops import (
    KernelOp, launch_counts, reset_launch_counts, event_scatter_add,
    event_scatter_add_multi, GatherPlan, build_gather_plan, plan_from_csr,
    plan_from_ell, gather_matvec, plan_matvec_dw, plan_inverse_perm,
    plan_matvec_vjp, build_mm_plan, gather_matmat, plan_matmat_vjp,
    pair_gather_product,
)
from .events import (
    BinaryArray, EventRepresentation, BitPackedBinary, bitpack, CompactBinary,
    binary_1d_array_index_p_call, binary_2d_compact_only_p_call,
    binary_2d_array_index_p_call, binary_2d_pair_stream_encode_p_call,
    binary_2d_row_sparse_encode_p_call, binary_2d_csr_row_count_p_call,
    binary_2d_csr_fill_p_call, binary_2d_csc_encode_p_call,
    binary_2d_csr_encode_p_call, binary_2d_csc_from_array,
)
from .dense import (
    Dense, binary_densemv, binary_densemv_p_call, binary_densemm,
    binary_densemm_p_call, update_dense_on_binary_pre,
    update_dense_on_binary_post,
)
from .csr import (
    CSR, CSC, csrmv, csrmm, binary_csrmv, binary_csrmm,
    binary_csrmv_indexed, binary_csrmm_indexed, update_csr_on_binary_pre,
    update_csr_on_binary_post, update_csc_on_binary_pre,
    update_csc_on_binary_post,
)
from .models import (
    LIFRefParams, LIFRefState, lifref_init, lifref_step, surrogate_spike,
    EINet, EINetState, einet_pallas_sim, einet_pallas_sim_mxu,
    einet_pallas_sim_mxu2, einet_pallas_sim_mxu3, einet_pallas_sim_mxu4,
    einet_pallas_sim_mxu5, einet_pallas_sim_mxu6, einet_pallas_sim_chain,
    einet_pallas_sim_dense, dense_count_table, mxu6_conn_table, SNNParams,
    SurrogateSNN, snn_loss, train_step, JITCNet, JITCNetState,
)
from .jitc import (
    JITCModeView, JITCWalkPlan, JITCScalarMatrix, JITCScalarR, JITCScalarC,
    jits, jitsmv, jitsmm, binary_jitsmv, binary_jitsmm, jitsmv_plan,
    jitsmm_plan, JITCNormalMatrix, JITCNormalR, JITCNormalC, jitn, jitnmv,
    jitnmm, binary_jitnmv, binary_jitnmm, jitnmv_plan, jitnmm_plan,
    JITCUniformMatrix, JITCUniformR, JITCUniformC, jitu, jitumv, jitumm,
    binary_jitumv, binary_jitumm, jitumv_plan, jitumm_plan,
)
from .interop import (einet_from_arrays, surrogate_snn_from_arrays,
                      csr_from_arrays, csc_from_arrays, jitc_net_from_arrays,
                      dense_from_arrays)

__all__ = [
    '__version__', '__version_info__', 'config',
    'BrainEventError', 'MathError', 'UnsupportedOperationError',
    'KernelError', 'KernelNotAvailableError', 'KernelCompilationError',
    'CompilationError', 'KernelExecutionError', 'CUDANotInstalledError',
    'KernelToolchainError', 'NvccNotFoundError', 'KernelLoadError',
    'KernelRegistrationError',
    'event_capacity', 'binary_fcnmv', 'binary_fcnmv_p_call', 'KernelOp',
    'launch_counts', 'reset_launch_counts', 'event_scatter_add',
    'event_scatter_add_multi', 'GatherPlan', 'build_gather_plan',
    'plan_from_csr', 'plan_from_ell', 'gather_matvec', 'plan_matvec_dw',
    'plan_inverse_perm', 'plan_matvec_vjp', 'build_mm_plan', 'gather_matmat',
    'plan_matmat_vjp', 'pair_gather_product', 'BinaryArray',
    'EventRepresentation', 'BitPackedBinary', 'bitpack', 'CompactBinary',
    'binary_1d_array_index_p_call', 'binary_2d_compact_only_p_call',
    'binary_2d_array_index_p_call', 'binary_2d_pair_stream_encode_p_call',
    'binary_2d_row_sparse_encode_p_call', 'binary_2d_csr_row_count_p_call',
    'binary_2d_csr_fill_p_call', 'binary_2d_csc_encode_p_call',
    'binary_2d_csr_encode_p_call', 'binary_2d_csc_from_array', 'Dense',
    'binary_densemv', 'binary_densemv_p_call', 'binary_densemm',
    'binary_densemm_p_call', 'update_dense_on_binary_pre',
    'update_dense_on_binary_post', 'dense_from_arrays', 'CSR', 'CSC',
    'csrmv', 'csrmm', 'binary_csrmv', 'binary_csrmm', 'binary_csrmv_indexed',
    'binary_csrmm_indexed',
    'update_csr_on_binary_pre', 'update_csr_on_binary_post',
    'update_csc_on_binary_pre', 'update_csc_on_binary_post',
    'LIFRefParams', 'LIFRefState', 'lifref_init', 'lifref_step',
    'surrogate_spike', 'EINet', 'EINetState', 'einet_pallas_sim',
    'einet_pallas_sim_mxu', 'einet_pallas_sim_mxu2', 'einet_pallas_sim_mxu3',
    'einet_pallas_sim_mxu4', 'einet_pallas_sim_mxu5', 'einet_pallas_sim_mxu6',
    'einet_pallas_sim_chain', 'einet_pallas_sim_dense', 'dense_count_table',
    'mxu6_conn_table', 'SNNParams', 'SurrogateSNN', 'snn_loss', 'train_step',
    'einet_from_arrays', 'surrogate_snn_from_arrays', 'csr_from_arrays',
    'csc_from_arrays', 'jitc_net_from_arrays', 'JITCNet', 'JITCNetState',
    'JITCModeView', 'JITCWalkPlan', 'JITCScalarMatrix', 'JITCScalarR',
    'JITCScalarC', 'jits', 'jitsmv', 'jitsmm', 'binary_jitsmv',
    'binary_jitsmm', 'jitsmv_plan', 'jitsmm_plan', 'JITCNormalMatrix',
    'JITCNormalR', 'JITCNormalC', 'jitn', 'jitnmv', 'jitnmm',
    'binary_jitnmv', 'binary_jitnmm', 'jitnmv_plan', 'jitnmm_plan',
    'JITCUniformMatrix', 'JITCUniformR', 'JITCUniformC', 'jitu', 'jitumv',
    'jitumm', 'binary_jitumv', 'binary_jitumm', 'jitumv_plan', 'jitumm_plan',
]
