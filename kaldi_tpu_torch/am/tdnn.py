"""TDNN-F chain acoustic model, inference forward.

Port of kaldi_tpu/am/tdnn.py (``splice``, ``TdnnFLayer``,
``TdnnConfig``, ``TdnnChain``) to ``torch.nn``.  Inference only:
batch norm uses the running mean and variance (flax's eps 1e-5, no
scale or bias).  Dense layers are ``nn.Linear`` (torch.matmul), as the
JAX package leaves them to XLA.  ``params_from_flax`` converts a flax
``{"params", "batch_stats"}`` tree (as numpy) into this module's
state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


def splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """(B, T, D) → (B, T, D·len(offsets)) taking frames at t+offset,
    clamped to the edges (nnet3 Offset/Append descriptor semantics)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    return torch.cat([x[:, (t + o).clamp(0, T - 1)] for o in offsets],
                     dim=-1)


class FrozenBatchNorm(nn.Module):
    """flax BatchNorm(use_running_average=True, use_scale=False,
    use_bias=False): (x − mean)·rsqrt(var + eps)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x):
        return (x - self.mean) * torch.rsqrt(self.var + self.eps)


class TdnnFLayer(nn.Module):
    """Factorized TDNN layer: Linear over [t−s, t] into the bottleneck,
    affine over [t, t+s] back to ``dim``, ReLU, batch norm, and a
    scaled bypass when the widths match."""

    def __init__(self, in_dim: int, dim: int, bottleneck: int,
                 time_stride: int = 1, bypass_scale: float = 0.66):
        super().__init__()
        self.time_stride = time_stride
        self.bypass_scale = bypass_scale
        ctx = 2 if time_stride else 1
        self.linear = nn.Linear(in_dim * ctx, bottleneck, bias=False)
        self.affine = nn.Linear(bottleneck * ctx, dim)
        self.batchnorm = FrozenBatchNorm(dim)
        self.dim = dim

    def forward(self, x):
        s = self.time_stride
        h = self.linear(splice(x, (-s, 0) if s else (0,)))
        h = self.affine(splice(h, (0, s) if s else (0,)))
        h = self.batchnorm(torch.relu(h))
        if x.shape[-1] == self.dim:
            h = h + self.bypass_scale * x
        return h


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
        H = cfg.hidden_dim
        self.input_affine = nn.Linear(3 * cfg.feat_dim, H)
        self.input_bn = FrozenBatchNorm(H)
        self.tdnnf = nn.ModuleList(
            TdnnFLayer(H, H, cfg.bottleneck_dim, time_stride=s)
            for s in cfg.layer_strides())
        self.prefinal = nn.Linear(H, H)
        self.prefinal_bn = FrozenBatchNorm(H)
        self.output_affine = nn.Linear(H, cfg.num_pdfs)

    def forward(self, x):
        h = self.input_affine(splice(x, (-1, 0, 1)))
        h = self.input_bn(torch.relu(h))
        for layer in self.tdnnf:
            h = layer(h)
        k = self.config.frame_subsampling_factor
        if k > 1:
            h = h[:, ::k]
        h = self.prefinal_bn(torch.relu(self.prefinal(h)))
        return self.output_affine(h)


def params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a kaldi_tpu TdnnChain
    (leaves as numpy arrays) → a ``TdnnChain`` state dict.  Dense
    kernels are transposed from (in, out) to (out, in)."""
    p, bs = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def dense(dst, src):
        sd[f"{dst}.weight"] = t(np.asarray(src["kernel"]).T)
        if "bias" in src:
            sd[f"{dst}.bias"] = t(src["bias"])

    def bn(dst, src):
        sd[f"{dst}.mean"] = t(src["mean"])
        sd[f"{dst}.var"] = t(src["var"])

    dense("input_affine", p["input_affine"])
    bn("input_bn", bs["input_bn"])
    i = 1
    while f"tdnnf{i}" in p:
        name = f"tdnnf{i}"
        dense(f"tdnnf.{i - 1}.linear", p[name]["linear"])
        dense(f"tdnnf.{i - 1}.affine", p[name]["affine"])
        bn(f"tdnnf.{i - 1}.batchnorm", bs[name]["batchnorm"])
        i += 1
    dense("prefinal", p["prefinal"])
    bn("prefinal_bn", bs["prefinal_bn"])
    dense("output_affine", p["output_affine"])
    return sd
