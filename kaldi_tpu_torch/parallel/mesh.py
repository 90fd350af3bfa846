"""Mesh and sharding helpers over the ranks of a process group.

Port of kaldi_tpu/parallel/mesh.py.  The original lays the devices of one
controller out as a ``jax.sharding.Mesh``; here every device is the card
of one process (one rank), and the mesh is the ranks of the initialized
``torch.distributed`` process group laid out row major as a (data, model)
grid, rank = i·model + j, as ``np.array(devices).reshape(data, model)``
lays devices out.  In a process with no process group it is a 1×1 mesh.

Axes:
  data  — utterance/chunk batches (the analogue of --nj job splitting):
          each rank takes a contiguous block of the batch's rows, as
          ``P("data")`` lays them out, and sums over the axis are
          ``all_reduce`` calls on the axis's group;
  model — tensor parallelism.  ``model_sharding_rules`` names how each
          parameter would split; ``shard_params`` refuses ``model > 1``
          (ROADMAP Queue 1 item 6: NG-SGD over sharded matrices).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.device import resolve_device

# a PartitionSpec: one mesh axis name (or None) per tensor dimension;
# () replicates
PartitionSpec = Tuple[Optional[str], ...]

TENSOR_PARALLEL_ITEM = ("tensor parallelism (model > 1) is not ported: "
                        "ROADMAP Queue 1 item 6, shard_params over the "
                        "model axis with NG-SGD over sharded matrices")


def _world() -> Tuple[int, int]:
    """(world size, rank) of the initialized process group; (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A (data, model) grid of ranks.  ``shape`` is ``{"data": d,
    "model": m}`` as the original's; this process is the rank at
    (``data_index``, ``model_index``) and computes on ``device``.
    ``data_group`` holds the ranks of this process's model index (the
    ranks a sum over the data axis spans), ``None`` when the data axis
    has one rank and no collective is needed."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, data_group=None):
        self.data, self.model = data, model
        self.rank = rank
        self.device = device
        self.data_group = data_group

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def all_reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the data axis (every rank of it must
        call); a no-op when the axis has one rank."""
        if self.data > 1:
            dist.all_reduce(t, group=self.data_group)
        return t

    def all_gather_data(self, obj) -> List:
        """Every data rank's ``obj`` (picklable), in data order."""
        if self.data == 1:
            return [obj]
        out = [None] * self.data
        dist.all_gather_object(out, obj, group=self.data_group)
        return out


def make_mesh(data: int = 0, model: int = 1,
              device: Optional[torch.device | str] = None) -> Mesh:
    """Mesh with (data, model) axes over the ranks of the process group;
    ``data=0`` puts every rank the model axis leaves on data.  A shape
    that does not cover the ranks raises: the original keeps the first
    data·model devices of one controller, but a rank left out of the
    mesh would leave its collectives waiting.  ``device`` defaults to the
    rank's device (``distributed.initialize``), else the card.  Every
    rank must call it, in the same order as its other group calls."""
    from kaldi_tpu_torch.parallel.distributed import rank_device
    n, rank = _world()
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    if data == 0:
        data = n // model
    if data * model != n:
        raise ValueError(f"a {data}x{model} mesh does not cover the {n} "
                         "ranks of the process group")
    if device is None:
        device = rank_device() or "cuda"
    device = resolve_device(device)
    data_group = None
    if model == 1:
        data_group = dist.group.WORLD if n > 1 else None
    elif data > 1:
        # every rank creates every group, in one order
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if rank % model == j:
                data_group = g
    return Mesh(data, model, rank, device, data_group)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a batch of ``batch_size``: contiguous blocks
    over 'data' in rank order, as ``P("data")`` lays them out (every rank
    of one data index takes the same rows).  The batch must divide over
    the axis."""
    if batch_size % mesh.data:
        raise KaldiError(f"a batch of {batch_size} rows does not divide "
                         f"over the data axis of {mesh.data}")
    per = batch_size // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def model_sharding_rules(path_names: Sequence[str]) -> PartitionSpec:
    """PartitionSpec of a parameter named by its path (flax's, ending in
    ``kernel``, or the port's state-dict name split at dots, ending in
    ``weight``).

    Dense kernels shard their output features over 'model' (column
    parallelism); biases and batch-norm statistics replicate.  The
    alternating row-parallel factor of TDNN-F ('affine' after 'linear')
    shards its INPUT dim so the pair needs only one collective.  A flax
    kernel is (in, out), a torch weight (out, in): the spec follows the
    tensor's own layout."""
    names = list(path_names)
    if names and names[-1] == "kernel":
        if "affine" in names:          # second factor: row-parallel
            return ("model", None)
        return (None, "model")         # column-parallel
    if names and names[-1] == "weight":
        if "affine" in names:
            return (None, "model")
        return ("model", None)
    return ()


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place ``model``'s parameters and buffers on the rank's device,
    laid out by ``model_sharding_rules``: replicated, as every spec is
    on a model axis of 1.  ``model > 1`` raises (tensor parallelism is
    not ported)."""
    if mesh.model > 1:
        raise KaldiError(TENSOR_PARALLEL_ITEM)
    return model.to(mesh.device)


def replicate(tree, mesh: Mesh):
    """Rank 0's values on every rank: each tensor of ``tree`` (a module's
    parameters and buffers, a dict or a list of tensors) broadcast in
    place from rank 0 of the mesh.  → ``tree``."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree
