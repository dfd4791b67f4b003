"""Process-group mesh and sharding layer.

PyTorch counterpart of ``quantization_tpu/parallel/mesh.py``.  JAX drives a
device mesh from one controller and GSPMD inserts the collectives; here each
device is driven by a process of its own (``torchrun``, or any launcher that
gives every process its rank), every collective is an explicit
``torch.distributed`` call, and a process holds only its part of a sharded
tensor:

* a ("data", "model") :class:`Mesh`: ``'data'`` over frames (the i.i.d. axis
  of this model family; there is no sequence axis) and optional ``'model'``
  over the feature dimension ``dim``, the ranks laid out row-major over
  (num_data, num_model), with one process group along each axis;
* the JAX package's sharding builders under the same names.  A
  :class:`Sharding` names the mesh axis that splits each tensor axis (JAX's
  ``PartitionSpec``): :meth:`Sharding.take` gives this rank's part of a
  whole tensor and :meth:`Sharding.gather` the whole tensor from the parts;
* :class:`MeshReducer`, the :class:`~quantization_tpu_torch.core.types.Reducer`
  that sums partial results over the mesh's groups.

Call :func:`init_distributed` once per process before :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import QuantizerParams, Reducer, resolve_device

AXES = ("data", "model")


def default_backend(world_size: Optional[int] = None) -> str:
    """``"nccl"`` when every rank of this host owns a card, else ``"gloo"``:
    for CPU tensors, and for ranks that share a card (NCCL refuses two ranks
    on one device)."""
    local = os.environ.get("LOCAL_WORLD_SIZE") or os.environ.get("WORLD_SIZE") or world_size or 1
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if 0 < int(local) <= cards else "gloo"


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def init_distributed(backend: Optional[str] = None, **kwargs) -> None:
    """Initialise ``torch.distributed``'s default process group (a no-op if
    it is initialised already).

    ``kwargs`` go to ``init_process_group`` (``init_method``, ``world_size``,
    ``rank``, ``timeout``); without them it reads the ``env://`` variables
    that ``torchrun`` sets.  ``backend`` defaults to :func:`default_backend`;
    the choice is not switched after a failure, and every failure of the
    initialisation propagates."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = default_backend(kwargs.get("world_size"))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0))))
    dist.init_process_group(backend=backend, **kwargs)


class Mesh:
    """A (num_data, num_model) grid of the ranks, row-major, as the JAX
    package reshapes its devices.  ``shape`` maps each axis name to its size,
    ``coords`` this rank's index along each, ``device`` the device this rank
    computes on.  Without an initialised process group the mesh is 1 x 1 and
    its collectives are the identity."""

    axis_names = AXES

    def __init__(self, num_data: int, num_model: int, device: torch.device):
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if num_data * num_model != world:
            raise ValueError(
                f"a {num_data} x {num_model} mesh needs {num_data * num_model} ranks, and "
                f"{world} {'are' if world > 1 else 'is'} running"
                + ("" if self.distributed else " (call init_distributed first)"))
        self.rank = dist.get_rank() if self.distributed else 0
        self.grid = np.arange(world).reshape(num_data, num_model)
        self.shape: Dict[str, int] = {"data": num_data, "model": num_model}
        d, m = divmod(self.rank, num_model)
        self.coords: Dict[str, int] = {"data": d, "model": m}
        self.device = device
        self._members = {"data": self.grid[:, m].tolist(), "model": self.grid[d].tolist()}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {"data": None, "model": None}
        if self.distributed:
            # every rank creates every group, in the same order, including
            # the groups it is not in
            for axis, lines in (("data", self.grid.T), ("model", self.grid)):
                for line in lines:
                    group = dist.new_group(line.tolist())
                    if self.rank in line:
                        self._groups[axis] = group

    def members(self, axis: str) -> List[int]:
        """The global ranks of this rank's group along ``axis``, in order."""
        return list(self._members[axis])

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over this rank's group along ``axis`` (a new
        tensor), bitwise the same on every member."""
        group = self._groups[axis]
        if group is None:
            return t
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The members' ``t`` along ``axis``, concatenated on ``dim`` in the
        members' order."""
        group = self._groups[axis]
        if group is None:
            return t
        t = t.contiguous()
        members = self._members[axis]
        if dist.get_backend(group) == "nccl":
            parts = [torch.empty_like(t) for _ in members]
            dist.all_gather(parts, t, group=group)
        else:
            # gloo takes CUDA tensors in broadcast and all_reduce only
            parts = [t if r == self.rank else torch.empty_like(t) for r in members]
            for r, part in zip(members, parts):
                dist.broadcast(part, src=r, group=group)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite ``t`` with rank 0's, on every rank."""
        if self.distributed:
            dist.broadcast(t, src=0)
        return t

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable), on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        on = self.device if dist.get_backend() == "nccl" else torch.device("cpu")
        dist.broadcast_object_list(box, src=0, device=on)
        return box[0]

    def barrier(self) -> None:
        """Return when every rank has reached this call."""
        if self.distributed:
            dist.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(
    num_data: Optional[int] = None,
    num_model: int = 1,
    device=None,
) -> Mesh:
    """A ('data', 'model') mesh over all ranks of the default process group.

    ``num_data`` defaults to ``world_size // num_model``; the mesh must hold
    every rank.  ``device`` defaults to ``cuda:{LOCAL_RANK}``; pass
    ``device="cpu"`` to compute on the CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_data is None:
        num_data = world // num_model
    if device is None:
        resolve_device()  # raises without CUDA
        device = torch.device("cuda", _local_rank())
    return Mesh(num_data, num_model, torch.device(device))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: ``spec[i]`` names the mesh axis that
    splits tensor axis ``i`` into equal parts (None: whole); axes past the
    spec are whole (JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``t``."""
        for i, axis in enumerate(self.spec):
            if axis is None:
                continue
            n, size = self.mesh.shape[axis], t.shape[i]
            if size % n:
                raise ValueError(f"axis {i} of size {size} does not split {n} ways over {axis!r}")
            t = t.narrow(i, self.mesh.coords[axis] * (size // n), size // n)
        return t.contiguous()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor, from every rank's part ``t`` (a collective)."""
        for i, axis in enumerate(self.spec):
            if axis is not None:
                t = self.mesh.all_gather(t, axis, dim=i)
        return t


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def data_sharding(mesh: Mesh) -> Sharding:
    """Sharding for (B, dim) frame batches: batch over 'data', dim over
    'model' (when it has more than one rank)."""
    if mesh.shape["model"] > 1:
        return Sharding(mesh, ("data", "model"))
    return Sharding(mesh, ("data",))


def batch_only_sharding(mesh: Mesh) -> Sharding:
    """Sharding for (B, ...) outputs like codes: batch over 'data' only."""
    return Sharding(mesh, ("data",))


def quantizer_param_sharding(mesh: Mesh) -> QuantizerParams:
    """A :class:`QuantizerParams` of shardings: codebooks and predictor
    weights split over 'model' on their dim axis, small leaves replicated.
    With num_model == 1 this degenerates to full replication."""
    repl = Sharding(mesh)
    split = mesh.shape["model"] > 1
    return QuantizerParams(
        centers=Sharding(mesh, (None, None, "model")) if split else repl,
        to_logits_w=Sharding(mesh, (None, "model")) if split else repl,
        to_logits_b=repl,
        logits_scale=repl,
        centers_scale=repl,
    )


def _map_params(fn, params: QuantizerParams, mesh: Mesh) -> QuantizerParams:
    shardings = quantizer_param_sharding(mesh)
    return QuantizerParams(**{f.name: fn(getattr(shardings, f.name), getattr(params, f.name))
                              for f in dataclasses.fields(QuantizerParams)})


def shard_params(params: QuantizerParams, mesh: Mesh) -> QuantizerParams:
    """This rank's part of whole parameters (on the mesh's device)."""
    return _map_params(lambda s, t: s.take(t.to(mesh.device)), params, mesh)


def gather_params(params: QuantizerParams, mesh: Mesh) -> QuantizerParams:
    """Whole parameters from every rank's part (the inverse of
    :func:`shard_params`; a collective that every rank calls)."""
    return _map_params(lambda s, t: s.gather(t), params, mesh)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global (B, dim) batch (and, with a model axis,
    its dim columns), on the mesh's device."""
    return data_sharding(mesh).take(x).to(mesh.device)


class _GlobalSum(torch.autograd.Function):
    """SUM all-reduce over one of the mesh's groups, with an identity
    backward: each rank's gradient is its own share of the whole batch's,
    and the trainer sums the gradients once after ``backward()``.  (The
    all-reduce's own adjoint, another SUM, would count every rank's share
    once on each rank.)"""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class MeshReducer(Reducer):
    """The :class:`~quantization_tpu_torch.core.types.Reducer` of a mesh:
    ``dims`` sums over the 'model' group, ``rows`` over the 'data' group.
    Every rank of the data group holds the same number of rows, so the
    whole batch's mean is the sum of the ranks' means over ``num_data``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.dim_parts = mesh.shape["model"]

    def _sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        if not self.mesh.distributed:
            return t
        return _GlobalSum.apply(t, self.mesh, axis)

    def dims(self, t: torch.Tensor) -> torch.Tensor:
        return self._sum(t, "model")

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return self._sum(t, "data")

    def mean(self, t: torch.Tensor, dim=None) -> torch.Tensor:
        local = t.mean() if dim is None else t.mean(dim=dim)
        return self.rows(local / self.mesh.shape["data"])

    def gather_dims(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_gather(t, "model", dim=t.ndim - 1)
