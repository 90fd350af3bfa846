"""TDNN-F chain acoustic model: forward, training mode and converters.

Port of kaldi_tpu/am/tdnn.py (``splice``, ``TdnnFLayer``,
``TdnnConfig``, ``TdnnChain``, ``RestrictedAttentionLayer``,
``semi_orthogonal_penalty``) to ``torch.nn``.  Batch norm has flax's semantics (``BatchNorm``): no scale
or bias, eps 1e-5; in training mode it normalizes by the batch mean and
the biased batch variance over (B, T) and moves the running statistics
by momentum 0.99, in eval mode it uses them.  Dense layers are
``nn.Linear`` (torch.matmul), as the JAX package leaves them to XLA.
``compute_dtype="bfloat16"`` runs every dense layer but the output one in
bfloat16 by explicit casts, as flax's ``dtype=`` does: the parameters
stay float32, and each ReLU output goes back to float32 before its batch
norm.  ``params_from_flax`` / ``params_to_flax`` convert between a flax
``{"params", "batch_stats"}`` tree (as numpy) and this module's state
dict; ``state_dict_from_flax`` / ``state_dict_to_flax`` do it for any
model whose torch module names are flax's (the xconfig, LSTM and
x-vector models).  ``init_like_flax`` draws fresh weights from flax's
initializers' distributions.

A ``TdnnChain`` sharded over a mesh's model axis (parallel/mesh.py
``shard_params``; ``tp`` set to the mesh) computes the unsharded
model's function with parallel/tensor.py's collectives: the dense
layers and each TDNN-F ``linear`` column-parallel, each ``affine``
row-parallel (its output summed over the axis, then its bias added
once); batch norm, ReLU, dropout and the bypass run on the replicated
activations, and the scores come out whole on every rank.

``TdnnFLayer``'s dropout is ported to its intent: the original builds an
``nn.Dropout`` that its trainers give no random key, so a model with
``dropout-proportion`` cannot train there.  Here training mode draws the
mask from the layer's ``generator`` (the trainer's seeded one), and eval
mode is the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """(B, T, D) → (B, T, D·len(offsets)) taking frames at t+offset,
    clamped to the edges (nnet3 Offset/Append descriptor semantics)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    return torch.cat([x[:, (t + o).clamp(0, T - 1)] for o in offsets],
                     dim=-1)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer(x)`` with input, weight and bias cast to ``dtype`` (None:
    as they are), as flax's ``Dense(dtype=...)`` computes."""
    if dtype is None:
        return layer(x)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(use_scale=False, use_bias=False)``: (x − mean)·
    rsqrt(var + eps) over the last axis.  Training mode takes mean and
    var of the batch and moves the running ones: r ← 0.99·r + 0.01·batch.
    The variance is the two-pass E[(x − E[x])²], equal in exact
    arithmetic to flax's fast E[x²] − E[x]², whose float32 rounding error
    grows as mean²/var: on a channel whose mean is tens of its deviation
    (a stats layer's window means feed the prefinal layer so) it moved the
    normalised outputs by ~1e-4 of their largest, with the order of the
    sums (card against CPU)."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        # the data-parallel ranks whose batches the statistics span, and
        # their count (1: this process's batch alone); set by
        # set_batch_norm_group
        self.group = None
        self.group_size = 1

    def forward(self, x):
        if not self.training:
            return (x - self.mean) * torch.rsqrt(self.var + self.eps)
        dims = tuple(range(x.dim() - 1))
        if self.group_size > 1:
            mu, var = self._global_moments(x, dims)
        else:
            mu = x.mean(dim=dims)
            var = ((x - mu) ** 2).mean(dim=dims)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mu)
            self.var.copy_(m * self.var + (1 - m) * var)
        return (x - mu) * torch.rsqrt(var + self.eps)

    def _global_moments(self, x, dims):
        """Mean and two-pass variance over the whole batch of the group's
        ranks: each rank's sums all-reduced by ``AllReduceSum`` (whose
        backward sums the ranks' gradients), so every rank normalizes, and
        moves its running statistics, by the same values.  The ranks hold
        equal shards (ChainTrainer(mesh=))."""
        n = (x.numel() // x.shape[-1]) * self.group_size
        mu = AllReduceSum.apply(x.sum(dim=dims), self.group) / n
        var = AllReduceSum.apply(((x - mu) ** 2).sum(dim=dims),
                                 self.group) / n
        return mu, var


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a process group's ranks, differentiable:
    the gradient of each rank's input is the sum of the ranks' output
    gradients (every rank's loss depends on every rank's input).  What
    ``torch.distributed.nn.functional.all_reduce`` computes, without its
    deprecation."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def set_batch_norm_group(model: nn.Module, group, size: int) -> None:
    """Every ``BatchNorm`` of ``model`` takes its training statistics over
    the ``size`` ranks of ``group`` (a data axis' process group)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group, mod.group_size = group, size


class TdnnFLayer(nn.Module):
    """Factorized TDNN layer: Linear over [t−s, t] into the bottleneck,
    affine over [t, t+s] back to ``dim``, ReLU, batch norm, and a
    scaled bypass when the widths match."""

    def __init__(self, in_dim: int, dim: int, bottleneck: int,
                 time_stride: int = 1, bypass_scale: float = 0.66,
                 dropout: float = 0.0):
        super().__init__()
        self.time_stride = time_stride
        self.bypass_scale = bypass_scale
        self.dropout = dropout
        # the dropout masks' source in training mode (None: torch's
        # global generator); trainers set their own
        self.generator: Optional[torch.Generator] = None
        ctx = 2 if time_stride else 1
        self.linear = nn.Linear(in_dim * ctx, bottleneck, bias=False)
        self.affine = nn.Linear(bottleneck * ctx, dim)
        self.batchnorm = BatchNorm(dim)
        self.dim = dim
        self.bottleneck = bottleneck
        # the mesh whose model axis shards the layer (shard_params)
        self.tp = None

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        s = self.time_stride
        if self.tp is not None:
            h = self._sharded_factors(x, dtype)
        else:
            h = dense(self.linear, splice(x, (-s, 0) if s else (0,)),
                      dtype)
            h = dense(self.affine, splice(h, (0, s) if s else (0,)), dtype)
        h = self.batchnorm(torch.relu(h).float())
        if self.dropout > 0.0 and self.training:
            h = dropout(h, self.dropout, self.generator)
        if x.shape[-1] == self.dim:
            h = h + self.bypass_scale * x
        return h

    def _sharded_factors(self, x, dtype):
        """``linear`` then ``affine`` with this rank's shards: the
        replicated input copied into the column-parallel ``linear`` (its
        bottleneck block), the spliced block through this rank's columns
        of ``affine``, the partial outputs summed over the model axis in
        float32, then the whole bias."""
        from kaldi_tpu_torch.parallel.tensor import (copy_to_model,
                                                     reduce_from_model)
        s = self.time_stride
        xin = splice(copy_to_model(x, self.tp), (-s, 0) if s else (0,))
        w1, w2 = self.linear.weight, self.affine.weight
        if dtype is not None:
            xin, w1, w2 = xin.to(dtype), w1.to(dtype), w2.to(dtype)
        h = F.linear(xin, w1)
        h = F.linear(splice(h, (0, s) if s else (0,)), w2)
        h = reduce_from_model(h.float(), self.tp)
        bias = self.affine.bias
        if dtype is not None:
            # the unsharded layer adds its bias in dtype
            return (h.to(dtype) + bias.to(dtype)).float()
        return h + bias


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training mode: each entry kept with
    probability 1 − rate and scaled by 1 / (1 − rate), the mask drawn
    from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class RestrictedAttentionLayer(nn.Module):
    """Time-restricted self-attention (nnet-attention-component.h
    RestrictedAttentionComponent), as the original computes it: Q, K, V
    denses, QKᵀ/√dh over all T frames with the band [t − left_ctx,
    t + right_ctx] kept and the rest set to −1e30, softmax, ·V, the
    ``out`` dense, batch norm, and a 0.66-scaled bypass when the widths
    are equal."""

    def __init__(self, in_dim: int, dim: int, num_heads: int = 4,
                 left_ctx: int = 9, right_ctx: int = 9,
                 bypass_scale: float = 0.66):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.left_ctx, self.right_ctx = left_ctx, right_ctx
        self.bypass_scale = bypass_scale
        inner = num_heads * (dim // num_heads)
        self.query = nn.Linear(in_dim, inner)
        self.key = nn.Linear(in_dim, inner)
        self.value = nn.Linear(in_dim, inner)
        self.out = nn.Linear(inner, dim)
        self.batchnorm = BatchNorm(dim)

    def forward(self, x):
        B, T, D = x.shape
        H = self.num_heads
        dh = self.dim // H
        q = self.query(x).reshape(B, T, H, dh)
        k = self.key(x).reshape(B, T, H, dh)
        v = self.value(x).reshape(B, T, H, dh)
        logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(dh)
        t = torch.arange(T, device=x.device)
        band = ((t[None, :] >= t[:, None] - self.left_ctx)
                & (t[None, :] <= t[:, None] + self.right_ctx))
        logits = torch.where(band, logits, torch.full_like(logits, -1e30))
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, H * dh)
        out = self.batchnorm(self.out(out))
        if D == self.dim:
            out = out + self.bypass_scale * x
        return out


@dataclasses.dataclass
class TdnnConfig:
    feat_dim: int = 40
    num_pdfs: int = 128
    hidden_dim: int = 512
    bottleneck_dim: int = 128
    num_layers: int = 9
    frame_subsampling_factor: int = 3
    # per-layer time strides: early layers short, later dilated (1d recipe)
    strides: Optional[Sequence[int]] = None
    # "bfloat16" runs the dense layers (not the output one) in bfloat16;
    # parameters and batch norm stay float32
    compute_dtype: str = "float32"

    def layer_strides(self) -> Sequence[int]:
        if self.strides is not None:
            return self.strides
        return [1, 1, 1] + [3] * (self.num_layers - 3)


class TdnnChain(nn.Module):
    """(B, T, feat_dim) → (B, ceil(T / sub), num_pdfs) chain outputs."""

    def __init__(self, config: TdnnConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.matmul_dtype = (torch.bfloat16
                             if cfg.compute_dtype == "bfloat16" else None)
        H = cfg.hidden_dim
        self.input_affine = nn.Linear(3 * cfg.feat_dim, H)
        self.input_bn = BatchNorm(H)
        self.tdnnf = nn.ModuleList(
            TdnnFLayer(H, H, cfg.bottleneck_dim, time_stride=s)
            for s in cfg.layer_strides())
        self.prefinal = nn.Linear(H, H)
        self.prefinal_bn = BatchNorm(H)
        self.output_affine = nn.Linear(H, cfg.num_pdfs)
        self.output_affine.zero_init = True
        # the mesh whose model axis shards the model (shard_params)
        self.tp = None

    def _dense(self, layer, x, dtype=None):
        if self.tp is None:
            return dense(layer, x, dtype)
        from kaldi_tpu_torch.parallel.tensor import column_parallel
        return column_parallel(layer, x, self.tp, dtype)

    def forward(self, x):
        dt = self.matmul_dtype
        h = self._dense(self.input_affine, splice(x, (-1, 0, 1)), dt)
        h = self.input_bn(torch.relu(h).float())
        for layer in self.tdnnf:
            h = layer(h, dt)
        k = self.config.frame_subsampling_factor
        if k > 1:
            h = h[:, ::k]
        h = self.prefinal_bn(torch.relu(self._dense(self.prefinal, h,
                                                    dt)).float())
        return self._dense(self.output_affine, h)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at ±2, scaled to variance
    1/fan_in (the truncated normal's std is 0.8796 of its scale)."""
    v = torch.empty(w.shape)
    nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(v * (math.sqrt(1.0 / fan_in) / .87962566103423978))


def init_like_flax(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh weights drawn as flax initialises the originals: dense and
    convolution kernels from lecun_normal, a dense layer marked
    ``zero_init`` (the output layers) all zero, one marked ``orthogonal``
    (an LSTM's recurrent kernels) from flax's orthogonal initializer,
    biases zero, batch-norm statistics (0, 1).  flax's bits differ (its
    own RNG); only the distributions agree."""
    from kaldi_tpu_torch.am.cnn import TimeHeightConv
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                if getattr(mod, "zero_init", False):
                    mod.weight.zero_()
                elif getattr(mod, "orthogonal", False):
                    w = torch.empty(mod.weight.shape)
                    nn.init.orthogonal_(w, generator=gen)
                    mod.weight.copy_(w)
                else:
                    _lecun_normal_(mod.weight, mod.in_features, gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, TimeHeightConv):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.mean.zero_()
                mod.var.fill_(1.0)
    return model


def init_tdnn(model: TdnnChain, seed: int = 0) -> TdnnChain:
    """``init_like_flax`` of a TdnnChain: dense kernels from
    lecun_normal, biases zero, the output layer's kernel zero."""
    return init_like_flax(model, seed)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Every TDNN-F layer of ``model`` draws its dropout masks from
    ``generator``."""
    for mod in model.modules():
        if isinstance(mod, TdnnFLayer):
            mod.generator = generator


def semi_orthogonal_penalty(model: nn.Module) -> torch.Tensor:
    """Σ ‖MMᵀ − scale·I‖² over the first factor M (bottleneck, in) of
    every TDNN-F layer in ``model``, scale = tr(MMᵀ)/bottleneck
    (nnet-utils.cc ConstrainOrthonormal's floating-scale objective).  A
    torch weight is flax's kernel transposed, so M is the weight
    itself; a layer sharded over a model axis gathers its rows of M first
    (the gather's backward keeps this rank's rows)."""
    total = 0.0
    for layer in model.modules():
        if not isinstance(layer, TdnnFLayer):
            continue
        m = layer.linear.weight
        if layer.tp is not None:
            from kaldi_tpu_torch.parallel.tensor import (gather_from_model,
                                                         shard_sizes)
            m = gather_from_model(m, layer.tp, shard_sizes(
                layer.bottleneck, layer.tp.model), dim=0)
        p = m @ m.T
        scale = torch.trace(p) / p.shape[0]
        total = total + torch.sum(
            (p - scale * torch.eye(p.shape[0], device=p.device)) ** 2)
    return total


def _blocks(sd_keys):
    """(flax params path, flax batch_stats path or None, state-dict
    prefix) of every dense layer and batch norm of a TdnnChain."""
    out = [(("input_affine",), None, "input_affine"),
           (None, ("input_bn",), "input_bn")]
    i = 0
    while f"tdnnf.{i}.linear.weight" in sd_keys:
        out += [((f"tdnnf{i + 1}", "linear"), None, f"tdnnf.{i}.linear"),
                ((f"tdnnf{i + 1}", "affine"), None, f"tdnnf.{i}.affine"),
                (None, (f"tdnnf{i + 1}", "batchnorm"), f"tdnnf.{i}.batchnorm")]
        i += 1
    out += [(("prefinal",), None, "prefinal"),
            (None, ("prefinal_bn",), "prefinal_bn"),
            (("output_affine",), None, "output_affine")]
    return out


def params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a kaldi_tpu TdnnChain
    (leaves as numpy arrays) → a ``TdnnChain`` state dict.  Dense
    kernels are transposed from (in, out) to (out, in)."""
    p, bs = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        # a copy: the tree's arrays may share memory with a JAX buffer
        return torch.tensor(np.asarray(a, np.float32))

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    keys = {f"tdnnf.{i - 1}.linear.weight"
            for i in range(1, len(p) + 1) if f"tdnnf{i}" in p}
    for ppath, bpath, dst in _blocks(keys):
        if ppath is not None:
            src = at(p, ppath)
            sd[f"{dst}.weight"] = t(np.asarray(src["kernel"]).T)
            if "bias" in src:
                sd[f"{dst}.bias"] = t(src["bias"])
        else:
            src = at(bs, bpath)
            sd[f"{dst}.mean"] = t(src["mean"])
            sd[f"{dst}.var"] = t(src["var"])
    return sd


def params_to_flax(state_dict) -> Dict[str, dict]:
    """A ``TdnnChain`` state dict → flax ``{"params", "batch_stats"}``
    with numpy float32 leaves (kernels transposed back to (in, out))."""
    sd = {k: v.detach().cpu().numpy().copy() for k, v in state_dict.items()}
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}

    def put(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    for ppath, bpath, src in _blocks(set(sd)):
        if ppath is not None:
            put(out["params"], ppath + ("kernel",),
                np.ascontiguousarray(sd[f"{src}.weight"].T))
            if f"{src}.bias" in sd:
                put(out["params"], ppath + ("bias",), sd[f"{src}.bias"])
        else:
            put(out["batch_stats"], bpath + ("mean",), sd[f"{src}.mean"])
            put(out["batch_stats"], bpath + ("var",), sd[f"{src}.var"])
    return out


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (leaves as numpy arrays) of a
    model whose torch modules carry flax's module names (the xconfig,
    LSTM and x-vector models) → its state dict: a leaf's path joined by
    dots, ``kernel`` → ``weight`` (a dense kernel (in, out) transposed, a
    convolution's HWIO kernel to torch's OIHW), ``bias``, ``mean`` and
    ``var`` as they are."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                k = "weight"
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            # a copy: the tree's arrays may share memory with a JAX buffer
            sd[".".join(path + (k,))] = torch.tensor(np.ascontiguousarray(a))

    for coll in ("params", "batch_stats"):
        walk(variables.get(coll, {}), ())
    return sd


def state_dict_to_flax(state_dict) -> Dict[str, dict]:
    """The inverse of ``state_dict_from_flax`` for models whose flax
    module names hold no dot: ``{"params", "batch_stats"}`` with numpy
    float32 leaves."""
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, v in state_dict.items():
        path = key.split(".")
        a = v.detach().cpu().numpy().astype(np.float32)
        coll = "batch_stats" if path[-1] in ("mean", "var") else "params"
        if path[-1] == "weight":
            path[-1] = "kernel"
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        tree = out[coll]
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = np.ascontiguousarray(a)
    return out
