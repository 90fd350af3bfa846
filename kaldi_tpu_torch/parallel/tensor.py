"""Tensor parallelism over the model axis of a mesh: shards and the
collectives of a sharded forward and backward.

The JAX package lays a parameter out by its PartitionSpec
(kaldi_tpu/parallel/mesh.py ``model_sharding_rules``) and lets XLA insert
the collectives.  Here each rank of the model axis holds its slice of
every sharded tensor (a ``Shard``: the dimension, the full size, and the
full indices each rank holds), and the model's forward calls the
collectives itself, as Megatron-LM's column- and row-parallel layers do:

  * ``copy_to_model``: forward the identity, backward the sum of the
    ranks' gradients (the input of a column-parallel layer, whose
    gradient each rank holds a part of);
  * ``reduce_from_model``: forward the sum over the ranks, backward the
    identity (the output of a row-parallel layer, whose value each rank
    holds a part of);
  * ``gather_from_model``: forward the ranks' slices joined along a
    dimension, backward this rank's slice of the gradient (the output of
    a column-parallel layer before a replicated use).

The collectives run in float32.  Every rank of one data index computes
the replicated activations from equal inputs, so they stay equal to the
bit.  ``am/tdnn.py`` ``AllReduceSum`` sums in both directions (batch-norm
moments over the data axis); a row-parallel output must not use it, or
every gradient upstream would come back ``model`` times over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn


def shard_bounds(n: int, m: int, j: int) -> Tuple[int, int]:
    """[lo, hi) of rank j's block when n entries split over m ranks in
    contiguous near-equal blocks (the first n % m ranks one longer)."""
    q, r = divmod(n, m)
    lo = j * q + min(j, r)
    return lo, lo + q + (1 if j < r else 0)


def shard_sizes(n: int, m: int) -> List[int]:
    return [hi - lo for lo, hi in (shard_bounds(n, m, j) for j in range(m))]


def strided_index(block: int, copies: int, m: int, j: int) -> torch.Tensor:
    """Full indices of rank j's part of a dimension made of ``copies``
    concatenated blocks of ``block`` entries (a spliced input
    [h(t), h(t+s)]): its block slice of every copy, in copy order."""
    lo, hi = shard_bounds(block, m, j)
    return torch.cat([torch.arange(c * block + lo, c * block + hi)
                      for c in range(copies)])


@dataclasses.dataclass
class Shard:
    """How a tensor splits over the model axis: along ``dim`` of size
    ``full`` in the whole tensor, rank j holding the entries
    ``index[j]`` (in that order)."""
    dim: int
    full: int
    index: List[torch.Tensor]

    @classmethod
    def contiguous(cls, dim: int, full: int, m: int) -> "Shard":
        return cls(dim, full, [torch.arange(*shard_bounds(full, m, j))
                               for j in range(m)])

    @classmethod
    def strided(cls, dim: int, block: int, copies: int, m: int) -> "Shard":
        return cls(dim, block * copies,
                   [strided_index(block, copies, m, j) for j in range(m)])

    def full_shape(self, t: torch.Tensor) -> Tuple[int, ...]:
        shape = list(t.shape)
        shape[self.dim] = self.full
        return tuple(shape)

    def take(self, full: torch.Tensor, j: int) -> torch.Tensor:
        """Rank j's slice of the whole tensor ``full``."""
        return full.index_select(
            self.dim, self.index[j].to(full.device)).contiguous()


def _all_gather(t: torch.Tensor, mesh, sizes: Sequence[int],
                dim: int) -> List[torch.Tensor]:
    """Every model rank's ``t`` (rank j's of length ``sizes[j]`` along
    ``dim``), padded to the longest for the collective and cut back."""
    dim = dim % t.dim()
    longest = max(sizes)
    if t.shape[dim] < longest:
        pad = list(t.shape)
        pad[dim] = longest - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    parts = mesh.all_gather_model(t.contiguous())
    return [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]


def gather_tensor(t: torch.Tensor, shard: Shard, mesh) -> torch.Tensor:
    """The whole tensor from every model rank's slice (no autograd; every
    rank of the axis must call)."""
    sizes = [len(ix) for ix in shard.index]
    parts = _all_gather(t.detach(), mesh, sizes, shard.dim)
    full = t.new_empty(shard.full_shape(t))
    for ix, part in zip(shard.index, parts):
        full.index_copy_(shard.dim, ix.to(t.device), part)
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_model(g.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_model(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, sizes, dim):
        ctx.lo = sum(sizes[:mesh.model_index])
        ctx.size, ctx.dim = sizes[mesh.model_index], dim
        return torch.cat(_all_gather(x, mesh, sizes, dim), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.lo, ctx.size).contiguous(), None,
                None, None)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, sizes: Sequence[int],
                      dim: int = -1) -> torch.Tensor:
    """This rank's contiguous block of ``dim`` → the whole, rank j's
    block ``sizes[j]`` long."""
    return _GatherFromModel.apply(x, mesh, list(sizes), dim % x.dim())


def column_parallel(layer: nn.Linear, x: torch.Tensor, mesh,
                    dtype=None) -> torch.Tensor:
    """A dense layer whose weight holds this rank's rows (its output
    features; ``layer.bias`` replicated, whole) on the replicated input
    ``x`` → the whole output on every rank: x copied, this rank's
    columns with its slice of the bias, gathered in float32."""
    n = layer.bias.shape[0]
    lo, hi = shard_bounds(n, mesh.model, mesh.model_index)
    w, b = layer.weight, layer.bias[lo:hi]
    x = copy_to_model(x, mesh)
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    h = nn.functional.linear(x, w, b)
    return gather_from_model(h.float(), mesh, shard_sizes(n, mesh.model))


def full_state_dict(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with every sharded tensor gathered whole:
    the unsharded model's layout (every rank of the model axis must
    call)."""
    shards = getattr(model, "tp_shards", {})
    return {k: (gather_tensor(v, shards[k], mesh) if k in shards
                else v.detach().clone())
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, state_dict, mesh) -> None:
    """Load an unsharded state dict into a sharded ``model``: this
    rank's slice of every sharded tensor, the rest whole."""
    shards = getattr(model, "tp_shards", {})
    j = mesh.model_index
    model.load_state_dict({k: (shards[k].take(v, j) if k in shards else v)
                           for k, v in state_dict.items()})
