# Port of kaldi_tpu/am/lstm.py (flax) to torch.nn.
"""LSTM acoustic models with stateful streaming.

Port of kaldi_tpu/am/lstm.py (``LstmConfig``, ``LstmpLayer``,
``LstmChain``, ``StreamingLstmScorer``; parity targets: the nnet3
LSTM recipes and the looped online computation that carries recurrent
state across chunks).  As in the original, ``forward`` returns (scores,
carries) and streaming passes the carries back in, so chunked scoring
equals offline scoring.

The cell is flax's ``OptimizedLSTMCell``: eight dense leaves, ``ii``,
``if``, ``ig``, ``io`` on the input (no bias) and ``hi``, ``hf``, ``hg``,
``ho`` on the recurrent side (with bias), gates i, f, g, o, carry (c, h).
They stay separate parameters, so NG-SGD preconditions and max-change
clamps each on its own, as the original's optimizer does; the forward
packs them into an ``nn.LSTM``'s weights (torch's gate order is flax's)
and runs it through ``torch.func.functional_call``: cuDNN's recurrence
on the card, forward and backward in float32 without TF32
(``cudnn_f32_call``).  The projection follows the scan
over the cell-sized h, as in the original (Kaldi's LSTMP feeds the
projection back into the gates).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from kaldi_tpu_torch.am.cnn import cudnn_f32_call

GATES = "ifgo"


# Copied from kaldi_tpu/am/lstm.py LstmConfig.
@dataclasses.dataclass
class LstmConfig:
    feat_dim: int = 40
    num_pdfs: int = 128
    hidden_dim: int = 256
    proj_dim: int = 128         # recurrent/output projection (LSTMP)
    num_layers: int = 2
    frame_subsampling_factor: int = 3


class LstmCell(nn.Module):
    """flax ``OptimizedLSTMCell``'s parameters, one ``nn.Linear`` a leaf
    under flax's names; the recurrent kernels are marked for the
    orthogonal initializer."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        for g in GATES:
            self.add_module(f"i{g}", nn.Linear(in_dim, hidden_dim,
                                               bias=False))
            rec = nn.Linear(hidden_dim, hidden_dim)
            rec.orthogonal = True
            self.add_module(f"h{g}", rec)
        # the recurrence's module, never registered: its weights come
        # from the leaves above at each call
        lstm = nn.LSTM(in_dim, hidden_dim, batch_first=True, device="meta")
        object.__setattr__(self, "_lstm", lstm)

    def forward(self, x, carry):
        """x (B, T, in), carry (c, h) each (B, H) → (hs (B, T, H), new
        carry (c, h))."""
        m = self._modules
        leaves = [m[f"{side}{g}"].weight for side in "ih" for g in GATES] \
            + [m[f"h{g}"].bias for g in GATES]
        hs, hn, cn = cudnn_f32_call(self._recur, x, carry[1], carry[0],
                                    *leaves)
        return hs, (cn, hn)

    def _recur(self, x, h, c, *leaves):
        """The packed LSTM over x from (h, c); leaves: the four input
        kernels, the four recurrent ones, their four biases."""
        w = {"weight_ih_l0": torch.cat(leaves[0:4]),
             "weight_hh_l0": torch.cat(leaves[4:8]),
             "bias_hh_l0": torch.cat(leaves[8:12])}
        w["bias_ih_l0"] = torch.zeros_like(w["bias_hh_l0"])
        hs, (hn, cn) = functional_call(
            self._lstm, w, (x, (h[None].contiguous(), c[None].contiguous())))
        return hs, hn[0], cn[0]


# Port of kaldi_tpu/am/lstm.py LstmpLayer.
class LstmpLayer(nn.Module):
    """LSTM with a projection after the scan (the original's LSTMP)."""

    def __init__(self, in_dim: int, hidden_dim: int, proj_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell = LstmCell(in_dim, hidden_dim)
        self.proj = nn.Linear(hidden_dim, proj_dim, bias=False)

    def forward(self, x, carry=None):
        """x (B, T, D) → ((B, T, proj), new carry (c, h))."""
        if carry is None:
            z = x.new_zeros(x.shape[0], self.hidden_dim)
            carry = (z, z)
        hs, carry = self.cell(x, carry)
        return self.proj(hs), carry


# Port of kaldi_tpu/am/lstm.py LstmChain.
class LstmChain(nn.Module):
    """Stacked LSTMP → output layer, with optional carried state."""

    def __init__(self, config: LstmConfig):
        super().__init__()
        cfg = self.config = config
        d = cfg.feat_dim
        for i in range(cfg.num_layers):
            self.add_module(f"lstm{i + 1}", LstmpLayer(d, cfg.hidden_dim,
                                                       cfg.proj_dim))
            d = cfg.proj_dim
        self.output_affine = nn.Linear(d, cfg.num_pdfs)
        self.output_affine.zero_init = True

    def forward(self, x, carries: Optional[Sequence] = None):
        cfg = self.config
        new_carries = []
        h = x
        for i in range(cfg.num_layers):
            c = carries[i] if carries is not None else None
            h, nc = self._modules[f"lstm{i + 1}"](h, c)
            new_carries.append(nc)
        k = cfg.frame_subsampling_factor
        if k > 1:
            h = h[:, k - 1::k]      # the last frame of each block
        return self.output_affine(h), new_carries


# Port of kaldi_tpu/am/lstm.py StreamingLstmScorer.
class StreamingLstmScorer:
    """Chunked scoring carrying the LSTM state: equals offline scoring.
    Chunks must be multiples of the subsampling factor (pad the last).
    The model runs in eval mode on its own device."""

    def __init__(self, model: LstmChain):
        self.model = model.eval()
        self._carries: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = \
            None

    def reset(self) -> None:
        self._carries = None

    def accept_features(self, feats) -> np.ndarray:
        """(T, D) chunk (T % subsample == 0), numpy or a tensor → (T //
        sub, P) scores."""
        k = self.model.config.frame_subsampling_factor
        assert feats.shape[0] % k == 0, "chunk must be a multiple of sub"
        dev = self.model.output_affine.weight.device
        x = torch.as_tensor(np.asarray(feats) if not isinstance(
            feats, torch.Tensor) else feats, dtype=torch.float32).to(dev)
        with torch.no_grad():
            scores, self._carries = self.model(x[None], self._carries)
        return scores[0].cpu().numpy()
