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
          parameter splits, and ``shard_params`` keeps each rank's
          slice of a ``TdnnChain`` (parallel/tensor.py); the ranks of one
          data index form its ``model_group``.  Other model classes
          raise for ``model > 1`` (ROADMAP Queue 1 item 6b).
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

TENSOR_PARALLEL_ITEM = ("tensor parallelism (model > 1) is ported for "
                        "TdnnChain only; {} waits for ROADMAP Queue 1 "
                        "item 6b (xconfig, LSTM and CNN models)")


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
    has one rank and no collective is needed; ``model_group`` the ranks
    i·model + j, j = 0..model−1, of this process's data index i, ``None``
    when the model axis has one rank."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, data_group=None, model_group=None):
        self.data, self.model = data, model
        self.rank = rank
        self.device = device
        self.data_group = data_group
        self.model_group = model_group

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

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the model axis (every rank of this
        data index must call); a no-op when the axis has one rank."""
        if self.model > 1:
            dist.all_reduce(t, group=self.model_group)
        return t

    def all_gather_model(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's ``t`` (all of one shape), in model order."""
        if self.model == 1:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.model)]
        dist.all_gather(out, t, group=self.model_group)
        return out


def make_mesh(data: int = 0, model: int = 1,
              device: Optional[torch.device | str] = None) -> Mesh:
    """Mesh with (data, model) axes over the ranks of the process group;
    ``data=0`` puts every rank the model axis leaves on data.  A shape
    that does not cover the ranks raises: the original keeps the first
    data·model devices of one controller, but a rank left out of the
    mesh would leave its collectives waiting.  ``device`` defaults to the
    rank's device (``distributed.initialize``), else the card.  On both
    axes above 1 it creates a process group for each model index (the
    data axis) and each data index (the model axis).  Every rank must
    call it, in the same order as its other group calls."""
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
    data_group = model_group = None
    if model == 1:
        data_group = dist.group.WORLD if n > 1 else None
    elif data == 1:
        model_group = dist.group.WORLD
    else:
        # every rank creates every group, in one order
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if rank % model == j:
                data_group = g
        for i in range(data):
            g = dist.new_group([i * model + j for j in range(model)])
            if rank // model == i:
                model_group = g
    return Mesh(data, model, rank, device, data_group, model_group)


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
    laid out by ``model_sharding_rules``: on a model axis above 1, each
    tensor whose spec names "model" keeps this rank's slice of that
    dimension and every ``()`` tensor stays whole.  Every rank must
    start from the same whole model (the sharded model then computes
    what it computes).

    Only a ``TdnnChain`` shards (any other class raises): its column-
    parallel weights (``linear`` and the dense layers) keep contiguous
    row blocks, and each TDNN-F ``affine`` (row-parallel) the columns
    that multiply this rank's ``linear`` outputs in its spliced input
    [h(t), h(t+s)]: block j of each splice copy, a strided set, not the
    contiguous block ``P("model", None)`` would give the flax kernel.
    The model records the ``Shard`` of each sharded tensor in
    ``tp_shards``, the replicated biases added as this rank's slice in
    ``tp_partial`` (their gradients are summed over the model axis), and
    its forward runs the collectives (am/tdnn.py)."""
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnFLayer
    from kaldi_tpu_torch.parallel.tensor import Shard
    model = model.to(mesh.device)
    if mesh.model == 1:
        return model
    if type(model) is not TdnnChain:
        raise KaldiError(TENSOR_PARALLEL_ITEM.format(type(model).__name__))
    m, j = mesh.model, mesh.model_index
    shards, partial = {}, []
    for name, p in list(model.named_parameters()):
        spec = model_sharding_rules(name.split("."))
        if "model" not in spec:
            continue
        dim = spec.index("model")
        owner = model.get_submodule(name.rsplit(".", 2)[0]) \
            if name.startswith("tdnnf.") else None
        if isinstance(owner, TdnnFLayer) and ".affine." in name:
            ctx = p.shape[1] // owner.bottleneck
            sh = Shard.strided(dim, owner.bottleneck, ctx, m)
        else:
            sh = Shard.contiguous(dim, p.shape[dim], m)
        mod_name, pname = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        setattr(mod, pname, nn.Parameter(sh.take(p.detach(), j),
                                         requires_grad=p.requires_grad))
        shards[name] = sh
        if dim == 0 and getattr(mod, "bias", None) is not None:
            partial.append(f"{mod_name}.bias")
    model.tp_shards, model.tp_partial = shards, partial
    for mod in model.modules():
        if isinstance(mod, (TdnnChain, TdnnFLayer)):
            mod.tp = mesh
    return model


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
