# Copyright 2026 The brainevent-tpu Authors.
# Licensed under the Apache License, Version 2.0.

"""The EI network sharded over the neuron axis of a device mesh
(``brainevent_tpu.parallel.sharding``), over ``torch.distributed``.

Every rank (one per device) runs the same program and owns a contiguous
block of ``n_loc = num / n_dev`` neurons: their state, and their rows of
the connection table (the outgoing targets, anywhere in the network). One
step on a rank:

1. one launch of K22 ``einet_shard_step`` (:mod:`.mega`) on its ``n_loc``
   neurons (``EINetParams.num = n_loc``): fold the counts of the previous
   step, update the membranes, and count this step's hits into
   full-length, shard-major partials ``(n_dev, 2, n_loc)`` int32, double
   buffered by parity (the launch zeroes the other parity's);
2. one ``reduce_scatter_tensor`` of those ``2 * num * 4`` bytes sums the
   partials over the ranks and hands each rank its ``(2, n_loc)`` counts,
   which K22 folds at the next step. No other collective runs in a step.

Both JAX routes, ``propagate='scatter'`` and ``'mxu6'``, run so. Counting
first and scaling after the sum keeps every partial an exact integer, so
the sharded run is bitwise the single-device ``EINet`` (whose fold and
update are K22's, ``csrc/einet_neuron.cuh``), and so bitwise the JAX
``ShardedEINet`` and ``EINet``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (NCCL for
``'cuda'``, gloo for ``'cpu'``); the caller initialises the process
group. States are ``DTensor`` s sharded over the neuron axis; a step
works on their local tensors.
"""

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.networks import EINet, EINetParams
from ..models.neurons import LIFRefParams
from ..ops.core import check_device
from . import _comm
from .mega import einet_shard_step

__all__ = ['ShardedEINet', 'ShardedEINetState', 'neuron_mesh',
           'host_chip_mesh']


def neuron_mesh(n_devices: Optional[int] = None, axis: str = 'neurons',
                device_type: str = 'cuda') -> DeviceMesh:
    """A 1-D device mesh over the neuron axis, of *n_devices* ranks
    (default: the whole process group). ``'cuda'`` without a card raises
    :class:`~brainevent_torch.CUDANotInstalledError`."""
    check_device(device_type)
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def host_chip_mesh(n_hosts: Optional[int] = None,
                   chips_per_host: Optional[int] = None,
                   axes=('hosts', 'chips'),
                   device_type: str = 'cuda') -> DeviceMesh:
    """A 2-D ``(hosts, chips)`` mesh: the outer axis across hosts, the
    inner one across the devices of a host (rank ``h * chips + c``). By
    default a host holds ``$LOCAL_WORLD_SIZE`` ranks (as ``torchrun`` sets
    it; else the whole group). The sharded ops take ``axis=('hosts',
    'chips')`` to shard their rows over both."""
    check_device(device_type)
    world = dist.get_world_size()
    if chips_per_host is None:
        chips_per_host = (world // n_hosts if n_hosts else
                          int(os.environ.get('LOCAL_WORLD_SIZE', world)))
    if n_hosts is None:
        n_hosts = max(1, world // chips_per_host)
    return init_device_mesh(device_type, (n_hosts, chips_per_host),
                            mesh_dim_names=tuple(axes))


class ShardedEINetState(NamedTuple):
    v: torch.Tensor            # (num,) DTensor, sharded over the neurons
    t_last: torch.Tensor       # (num,)
    g_e: torch.Tensor          # (num,)
    g_i: torch.Tensor          # (num,)
    spike_count: torch.Tensor  # (num,) int32


@dataclasses.dataclass
class ShardedEINet:
    """EI network sharded over the neuron axis of a device mesh.

    Connectivity is one ELL table ``indices (num, n_conn)`` (row ``i``:
    the outgoing targets of neuron ``i``), row-sharded with the neuron
    state; the first ``n_exc = int(num * exc_fraction)`` rows are
    excitatory. Without ``indices`` the table is drawn from
    ``torch.Generator().manual_seed(seed)``, not JAX's draw: to simulate
    the JAX network, use :func:`from_einet` on a port ``EINet`` built from
    its arrays, or :func:`brainevent_torch.interop.sharded_einet_from_arrays`.
    """
    mesh: DeviceMesh
    num: int = 4096
    exc_fraction: float = 0.8
    n_conn: int = 80
    dt: float = 0.1
    w_e: float = 0.6
    w_i: float = 6.7
    tau_e: float = 5.0
    tau_i: float = 10.0
    e_e: float = 0.0
    e_i: float = -80.0
    coba: bool = True
    seed: int = 0
    indices: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    # the JAX routes, 'scatter' (event_scatter_add partials) and 'mxu6'
    # (the mega-kernel's); both count first and are bitwise alike, and
    # both run K22 here
    propagate: str = 'scatter'

    def __post_init__(self):
        self.axis = self.mesh.mesh_dim_names[0]
        self._axis = _comm.mesh_axis(self.mesh, self.axis)
        self.n_dev = self._axis.size
        if self.num % self.n_dev != 0:
            raise ValueError(
                f'num ({self.num}) must be divisible by the mesh size '
                f'({self.n_dev}).')
        if self.propagate not in ('scatter', 'mxu6'):
            raise ValueError(
                f"propagate must be 'scatter' or 'mxu6', got "
                f"{self.propagate!r}")
        self.n_exc = int(self.num * self.exc_fraction)
        self.n_loc = self.num // self.n_dev
        self.row0 = self._axis.index * self.n_loc
        self.params = LIFRefParams()
        self.device = check_device(self.mesh.device_type)
        if self.device.type == 'cuda':
            self.device = torch.device('cuda', torch.cuda.current_device())
        if self.indices is None:
            gen = torch.Generator().manual_seed(self.seed)
            self.indices = torch.randint(0, self.num, (self.num, self.n_conn),
                                         generator=gen, dtype=torch.int32)
        else:
            self.indices = torch.as_tensor(self.indices)
            if tuple(self.indices.shape) != (self.num, self.n_conn):
                raise ValueError(
                    f'indices shape {tuple(self.indices.shape)} != '
                    f'({self.num}, {self.n_conn})')
        # this rank's rows of the table, on its device
        self.indices_loc = self.indices[self.row0:self.row0 + self.n_loc].to(
            device=self.device, dtype=torch.int32).contiguous()

    @classmethod
    def from_einet(cls, einet, mesh: DeviceMesh) -> 'ShardedEINet':
        """Shard a single-device :class:`~..models.EINet`: the same table,
        weights and dynamics, so the sharded run can be held state for
        state against it."""
        return cls(mesh=mesh, num=einet.num,
                   exc_fraction=einet.n_exc / einet.num,
                   n_conn=einet.conn_all.shape[1], dt=einet.dt,
                   w_e=einet.w_e, w_i=einet.w_i,
                   tau_e=einet.tau_e, tau_i=einet.tau_i,
                   e_e=einet.e_e, e_i=einet.e_i, coba=einet.coba,
                   seed=einet.seed, indices=einet.conn_all)

    # -- state ---------------------------------------------------------------------

    def _shard(self, x, dtype) -> torch.Tensor:
        """This rank's block of the global ``(num,)`` array *x*, as a
        ``DTensor`` sharded over the neurons."""
        x = _comm.global_tensor(x)
        loc = x[self.row0:self.row0 + self.n_loc].to(
            device=self.device, dtype=dtype).contiguous()
        return _comm.sharded(loc, self._axis, self.num)

    def shard_state(self, v, t_last, g_e, g_i,
                    spike_count) -> ShardedEINetState:
        """A state from global ``(num,)`` arrays (tensors, numpy arrays or
        ``DTensor`` s); each rank keeps its block."""
        f, i = torch.float32, torch.int32
        return ShardedEINetState(
            v=self._shard(v, f), t_last=self._shard(t_last, f),
            g_e=self._shard(g_e, f), g_i=self._shard(g_i, f),
            spike_count=self._shard(spike_count, i))

    def init_state(self) -> ShardedEINetState:
        """Membranes ~ N(-55, 2) from ``seed + 1`` (not JAX's draw), no
        spike yet, no synaptic input."""
        gen = torch.Generator().manual_seed(self.seed + 1)
        v = -55.0 + 2.0 * torch.randn(self.num, generator=gen)
        zeros = torch.zeros(self.num)
        return self.shard_state(v, torch.full((self.num,), -1e7), zeros,
                                zeros, torch.zeros(self.num,
                                                   dtype=torch.int32))

    def init_state_from(self, einet_state) -> ShardedEINetState:
        """Shard a single-device :class:`~..models.EINetState` (for exact
        cross-validation against the single-device engine)."""
        return self.shard_state(
            einet_state.neurons.v, einet_state.neurons.t_last,
            einet_state.g_e, einet_state.g_i, einet_state.spike_count)

    # -- dynamics ----------------------------------------------------------------------

    def step_params(self, inp: float = 20.0) -> EINetParams:
        """The float32 scalars K22 reads, for this rank's ``n_loc``
        neurons: ``EINet``'s, from the same fields, so that both round
        alike."""
        p = EINet.step_params(self, inp)
        p.num = self.n_loc
        return p

    def _simulate(self, state: ShardedEINetState, times, inp: float
                  ) -> ShardedEINetState:
        """The run on this rank's neurons: per step one K22 launch (fold,
        update, the step's partials into parity ``k & 1``, the other
        parity zeroed) and one reduce-scatter of the partials into the
        counts K22 folds next; a last K22 launch only folds. The state is
        copied, not modified."""
        p = self.step_params(inp)
        f, i = torch.float32, torch.int32
        v, t_last, g_e, g_i, spike_count = (
            (x.to_local() if hasattr(x, 'to_local') else x).to(
                self.device, dtype, copy=True)
            for x, dtype in zip(state, (f, f, f, f, i)))
        counts = torch.zeros(2, self.n_loc, dtype=i, device=self.device)
        partials = torch.zeros(2, self.n_dev, 2, self.n_loc, dtype=i,
                               device=self.device)
        group = self._axis.group

        def launch(t, parity, fold, step):
            einet_shard_step(v, t_last, g_e, g_i, counts, spike_count,
                             partials, self.indices_loc, self.row0,
                             self.n_exc, p, t, parity, fold, step)
        for k, t in enumerate(times):
            launch(t, k & 1, k > 0, True)
            dist.reduce_scatter_tensor(counts.view(-1),
                                       partials[k & 1].view(-1), group=group)
        if len(times):
            launch(0.0, 0, True, False)
        return ShardedEINetState(
            *(_comm.sharded(x, self._axis, self.num)
              for x in (v, t_last, g_e, g_i, spike_count)))

    times = EINet.times

    # -- public API ----------------------------------------------------------------------

    def step_fn(self):
        """A sharded step ``(state, t, inp=20.0) -> state``: one K22 step,
        one reduce-scatter and a K22 fold."""
        return lambda state, t, inp=20.0: self._simulate(
            state, [float(np.float32(t))], inp)

    def run(self, n_steps: int, inp: float = 20.0,
            state: Optional[ShardedEINetState] = None) -> ShardedEINetState:
        """Run ``n_steps`` of the sharded simulation from *state* (default
        :meth:`init_state`), which is not modified."""
        if state is None:
            state = self.init_state()
        return self._simulate(state, self.times(n_steps), inp)
