"""A ``("data", "model")`` mesh over a ``torch.distributed`` process
group and the field's sharding on it (port of
``text2nerf_tpu/parallel/mesh.py``).

- ``data``: the ray batch's leading axis is split over it; parameters
  are replicated along it, and the train step averages the gradients
  over it before Adam.
- ``model``: the app channels of every plane and line and the basis
  rows are split over it (tensor parallelism).  The fields store density
  ‖ app channels fused per axis, so a model shard is a field of the same
  decomposition whose tables hold the density channels (replicated) and
  its slice of the app channels.  Its basis product is a partial sum,
  summed over ``model`` by :class:`ModelSum` (all-reduce forward,
  identity backward: every model rank computes the same loss).  The
  orthogonality term's whole app lines are put back together the same
  way (:func:`model_gather`).

Rank r sits at (r // model, r % model), the layout of
``init_device_mesh((data, model))``.  The groups are built with
``torch.distributed.new_group`` and use only ``all_reduce``, which the
gloo backend also runs on CUDA tensors.  Every rank of the process group
must call :func:`make_mesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import tensorf as tf


@dataclasses.dataclass
class Mesh:
    data: int
    model: int
    rank: int
    data_group: Optional[object]   # this rank's group along "data" (None: size 1)
    model_group: Optional[object]  # this rank's group along "model" (None: size 1)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over the initialized default process
    group; ``data`` defaults to world_size // model."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} != {world} ranks")
    grid = np.arange(world).reshape(data, model)
    data_group = model_group = None
    # every rank creates every group, in the same order
    for m in range(model):
        g = dist.new_group([int(r) for r in grid[:, m]]) if data > 1 else None
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([int(r) for r in grid[d]]) if model > 1 else None
        if rank // model == d:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group)


class _AllReduceIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelSum:
    """Sum over the model axis, identity in the backward pass (the loss
    is replicated over ``model``, so each shard's gradient is the whole
    loss's).  A field's ``app_reduce``; copies share it."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, x):
        if self.mesh.model_group is None:
            return x
        return _AllReduceIdentity.apply(x, self.mesh.model_group)

    def __deepcopy__(self, memo):
        return self


def model_gather(x, mesh: Mesh):
    """The whole tensor along the last (channel) axis from each model
    rank's equal slice ``x`` (slice m at offset m · width): ``x`` is
    written into zeros of the whole width and summed over ``model`` (the
    mesh's one collective; gloo's ``all_gather`` takes CPU tensors only).
    Every model rank gets the same tensor; the backward is the identity
    into the zeros, so each rank's gradient is its own slice of the whole
    gradient, with no second reduction (the loss that uses it is
    replicated over ``model``)."""
    if mesh.model_group is None:
        return x
    m, w = mesh.model_index, x.shape[-1]
    before = x.new_zeros((*x.shape[:-1], m * w))
    after = x.new_zeros((*x.shape[:-1], (mesh.model - 1 - m) * w))
    return ModelSum(mesh)(torch.cat([before, x, after], -1))


def model_mean(x, mesh: Mesh):
    """Mean over the model axis of a per-shard partial (the regularizers'
    channel means, each shard holding an equal share of the channels)."""
    return ModelSum(mesh)(x) / mesh.model


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a tensor lies over ``model`` (JAX's ``PartitionSpec``, widened
    for the fused tables): dimension ``dim`` is a run of ``blocks``, each
    ``(size, split)``.  A split block is cut into ``model`` equal slices,
    slice m on model rank m; a whole block is on every rank.  ``dim``
    None: replicated."""

    dim: Optional[int] = None
    blocks: tuple = ()

    def shard_shape(self, shape, mesh: Mesh) -> tuple:
        """The shape of this rank's part of a tensor shaped ``shape``."""
        out = list(shape)
        if self.dim is not None:
            out[self.dim] = sum(size // mesh.model if split else size
                                for size, split in self.blocks)
        return tuple(out)

    def take(self, t, mesh: Mesh):
        """This rank's part of ``t``."""
        if self.dim is None:
            return t
        if sum(size for size, _ in self.blocks) != t.shape[self.dim]:
            raise ValueError(f"blocks {self.blocks} do not cover dim {self.dim} of "
                             f"{tuple(t.shape)}")
        parts, off = [], 0
        for size, split in self.blocks:
            w = size // mesh.model if split else size
            parts.append(t.narrow(self.dim, off + mesh.model_index * w if split else off, w))
            off += size
        return torch.cat(parts, self.dim)

    def gather(self, part, mesh: Mesh):
        """The whole tensor from every model rank's ``part`` (the inverse
        of :meth:`take`; outside autograd): each rank writes its slices
        into zeros, the whole blocks from model rank 0 only, and the sum
        over ``model`` is exact.  Every model rank gets the tensor."""
        if self.dim is None or mesh.model_group is None:
            return part
        shape = list(part.shape)
        shape[self.dim] = sum(size for size, _ in self.blocks)
        out = part.new_zeros(shape)
        off = src = 0
        for size, split in self.blocks:
            w = size // mesh.model if split else size
            if split or mesh.model_index == 0:
                dst = off + mesh.model_index * w if split else off
                out.narrow(self.dim, dst, w).copy_(part.narrow(self.dim, src, w))
            off, src = off + size, src + w
        dist.all_reduce(out, group=mesh.model_group)
        return out


def replicated(mesh: Mesh) -> ShardSpec:
    return ShardSpec()


def shard_batch(batch, mesh: Mesh):
    """This rank's part of ``batch`` (a dict of arrays or tensors): the
    leading axis split over ``data`` into equal parts."""

    def part(x):
        n = x.shape[0]
        if n % mesh.data:
            raise ValueError(f"batch of {n} does not split over data={mesh.data}")
        k = n // mesh.data
        return x[mesh.data_index * k:(mesh.data_index + 1) * k]

    return {k: part(v) for k, v in batch.items()}


def _app_counts(field: tf.TensoRF, model: int):
    nd, na = tf.component_counts(field.cfg)
    for a in na:
        if a % model:
            raise ValueError(f"app components {na} do not split over model={model}")
    return nd, na


def param_sharding_spec(field: tf.TensoRF, mesh: Mesh) -> dict:
    """{parameter name: ShardSpec}.  Along the channel axis of each fused
    plane (H, W, nd + na) and line (L, nd + na) of axis i: its nd[i]
    density channels whole on every rank, its na[i] app channels split
    over ``model``.  The basis rows: one block of app channels per axis
    (CP: one block), each split over ``model``.  Everything else, and
    everything at model 1, replicated."""
    specs = {name: replicated(mesh) for name, _ in field.named_parameters()}
    if mesh.model == 1:
        return specs
    nd, na = _app_counts(field, mesh.model)
    for kind in ("planes", "lines"):
        for i in range(len(getattr(field, kind))):
            specs[f"{kind}.{i}"] = ShardSpec(-1, ((nd[i], False), (na[i], True)))
    rows = na[:1] if field.is_cp else na
    specs["basis"] = ShardSpec(0, tuple((a, True) for a in rows))
    return specs


def shard_tensors(field: tf.TensoRF, mesh: Mesh, tables, basis):
    """This rank's part, by :func:`param_sharding_spec`, of per-parameter
    tensors shaped like ``field``'s (``tables``: its planes then its
    lines; ``basis``).  Also splits gradients and moments."""
    specs = param_sharding_spec(field, mesh)
    names = [*(f"planes.{i}" for i in range(len(field.planes))),
             *(f"lines.{i}" for i in range(len(field.lines)))]
    return ([specs[n].take(t, mesh) for n, t in zip(names, tables, strict=True)],
            specs["basis"].take(basis, mesh))


def shard_params(field: tf.TensoRF, mesh: Mesh) -> tf.TensoRF:
    """This rank's shard of ``field`` (a new field on the same device):
    a field of ``app_n_comp / model`` components per axis whose basis
    product is summed over ``model``.  With model 1 it is a copy."""
    _, na = _app_counts(field, mesh.model)
    cfg = dataclasses.replace(field.cfg, app_n_comp=tuple(a // mesh.model for a in na))
    specs = param_sharding_spec(field, mesh)
    with torch.no_grad():
        shard = tf.TensoRF(cfg, tf.grid_resolution(field), device=field.basis.device,
                           dtype=field.basis.dtype)
        dst = dict(shard.named_parameters())
        for name, p in field.named_parameters():
            part = specs[name].take(p, mesh)
            if part.shape != dst[name].shape:
                raise ValueError(f"{name}: shard {tuple(part.shape)} != the shard field's "
                                 f"{tuple(dst[name].shape)}")
            dst[name].copy_(part)
    shard.requires_grad_(field.basis.requires_grad)
    shard.app_reduce = ModelSum(mesh) if mesh.model > 1 else None
    return shard
