# Port of kaldi_tpu/am/xvector.py (flax + optax) to PyTorch.
"""X-vector speaker embeddings: TDNN frame layers → statistics pooling
→ segment-level embedding, trained as a speaker classifier.

Port of kaldi_tpu/am/xvector.py (``StatisticsPooling``,
``XvectorConfig``, ``XvectorNet``, ``train_xvector``,
``extract_xvector``, ``save_xvector_model`` / ``load_xvector_model``;
parity targets: the reference's StatisticsExtraction/Pooling components
and the sre16 v2 x-vector recipe) to ``torch.nn``.  Module names are
flax's, so ``am/tdnn.py``'s ``state_dict_from_flax`` /
``state_dict_to_flax`` carry weights across, and an ``<XvectorModel>``
file holds flax's tree: the two packages' files cross both ways, byte
for byte.  Training runs on ``device`` with ``torch.optim.Adam`` (optax's
adam: b1 0.9, b2 0.999, eps 1e-8) and the original's numpy draws of
batches and chunk offsets.  The frame splice keeps the original's
``roll``: a window at the utterance's end wraps onto its first frames
(Kaldi pads at the edges).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kaldi_tpu_torch.am.tdnn import (BatchNorm, init_like_flax,
                                     state_dict_from_flax,
                                     state_dict_to_flax)
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/am/xvector.py StatisticsPooling.
class StatisticsPooling(nn.Module):
    """Masked mean + stddev over time: (B, T, D), mask (B, T) → (B, 2D);
    the variance is floored at ``eps``.  No parameters."""

    def __init__(self, eps: float = 1e-4):
        super().__init__()
        self.eps = eps

    def forward(self, x, mask=None):
        if mask is None:
            mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        m = mask.to(x.dtype)[..., None]
        n = torch.clamp(m.sum(dim=1), min=1.0)
        mean = (x * m).sum(dim=1) / n
        var = (x * x * m).sum(dim=1) / n - mean ** 2
        return torch.cat([mean, torch.sqrt(torch.clamp(var, min=self.eps))],
                         dim=-1)


# Copied from kaldi_tpu/am/xvector.py XvectorConfig.
@dataclasses.dataclass
class XvectorConfig:
    feat_dim: int = 23
    num_speakers: int = 100
    hidden_dim: int = 128
    embed_dim: int = 64
    # frame-level TDNN context splices per layer (x-vector paper/recipe:
    # growing dilated contexts, then 1x1 layers)
    contexts: Sequence[Sequence[int]] = ((-2, -1, 0, 1, 2), (-2, 0, 2),
                                         (-3, 0, 3), (0,), (0,))


def _splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    return torch.cat([torch.roll(x, -o, dims=1) for o in offsets], dim=-1)


# Port of kaldi_tpu/am/xvector.py XvectorNet.
class XvectorNet(nn.Module):
    """Frame TDNN stack → stats pooling → two embedding layers → speaker
    logits; ``return_embedding`` gives the first embedding layer before
    its nonlinearity (the recipe's extraction point)."""

    def __init__(self, config: XvectorConfig):
        super().__init__()
        cfg = self.config = config
        d = cfg.feat_dim
        for i, ctx in enumerate(cfg.contexts):
            self.add_module(f"tdnn{i + 1}",
                            nn.Linear(d * len(ctx), cfg.hidden_dim))
            self.add_module(f"bn{i + 1}", BatchNorm(cfg.hidden_dim))
            d = cfg.hidden_dim
        self.stats_pool = StatisticsPooling()
        self.embed_a = nn.Linear(2 * d, cfg.embed_dim)
        self.bn_embed_a = BatchNorm(cfg.embed_dim)
        self.embed_b = nn.Linear(cfg.embed_dim, cfg.embed_dim)
        self.bn_embed_b = BatchNorm(cfg.embed_dim)
        self.output = nn.Linear(cfg.embed_dim, cfg.num_speakers)

    def forward(self, x, mask=None, return_embedding: bool = False):
        m = self._modules
        h = x
        for i, ctx in enumerate(self.config.contexts):
            h = m[f"bn{i + 1}"](torch.relu(m[f"tdnn{i + 1}"](_splice(h, ctx))))
        emb_a = self.embed_a(self.stats_pool(h, mask))
        if return_embedding:
            return emb_a
        h = self.bn_embed_a(torch.relu(emb_a))
        h = self.bn_embed_b(torch.relu(self.embed_b(h)))
        return self.output(h)


def init_xvector(cfg: XvectorConfig, seed: int,
                 device: torch.device) -> XvectorNet:
    """A fresh XvectorNet on ``device``, drawn from flax's
    initializers' distributions (``init_like_flax``)."""
    return init_like_flax(XvectorNet(cfg), seed).to(device)


# Port of kaldi_tpu/am/xvector.py train_xvector.
def train_xvector(feats: Dict[str, np.ndarray], utt2spk: Dict[str, str],
                  cfg: XvectorConfig, num_epochs: int = 30,
                  batch_size: int = 16, chunk: int = 64,
                  learning_rate: float = 1e-3, seed: int = 0,
                  device: torch.device | str = "cuda"):
    """Speaker-classification training on fixed-length chunks (the
    recipe trains on random 2-4 s chunks for length invariance).
    Returns (trained model in eval mode, speaker list)."""
    dev = resolve_device(device)
    spks = sorted(set(utt2spk.values()))
    spk_id = {s: i for i, s in enumerate(spks)}
    cfg = dataclasses.replace(cfg, num_speakers=len(spks))
    rng = np.random.default_rng(seed)
    utts = sorted(feats)
    model = init_xvector(cfg, seed, dev)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    model.train()
    batch_size = min(batch_size, len(utts))
    for epoch in range(num_epochs):
        order = rng.permutation(len(utts))
        losses = []
        for i in range(0, len(order) - batch_size + 1, batch_size):
            xb = np.zeros((batch_size, chunk, cfg.feat_dim), np.float32)
            yb = np.zeros(batch_size, np.int64)
            for b, ui in enumerate(order[i:i + batch_size]):
                f = feats[utts[ui]]
                if f.shape[0] >= chunk:
                    t0 = rng.integers(0, f.shape[0] - chunk + 1)
                    xb[b] = f[t0:t0 + chunk]
                else:
                    xb[b, :f.shape[0]] = f
                yb[b] = spk_id[utt2spk[utts[ui]]]
            logits = model(torch.from_numpy(xb).to(dev))
            loss = F.cross_entropy(logits, torch.from_numpy(yb).to(dev))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if epoch % 5 == 0 or epoch == num_epochs - 1:
            log.info("xvector epoch %d: loss %.3f", epoch,
                     float(torch.stack(losses).mean()) if losses else 0.0)
    return model.eval(), spks


# Port of kaldi_tpu/am/xvector.py extract_xvector.
def extract_xvector(model: XvectorNet, feats) -> np.ndarray:
    """Whole-utterance embedding (nnet3-xvector-compute role)."""
    dev = model.output.weight.device
    x = torch.as_tensor(np.asarray(feats, np.float32)).to(dev)[None]
    model.eval()
    with torch.no_grad():
        return model(x, return_embedding=True)[0].cpu().numpy()


# Port of kaldi_tpu/am/xvector.py save_xvector_model.
def save_xvector_model(path: str, model: XvectorNet,
                       spk_list: Sequence[str]) -> None:
    """An x-vector net (params, batch statistics, config, speaker list)
    with Kaldi token framing — the final.raw role of the sre16 xvector
    recipe; the parameters as flax's tree."""
    from kaldi_tpu_torch.am.serialize import write_pytree
    from kaldi_tpu_torch.core import io as kio
    cfg = model.config
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<XvectorModel>")
        for tok, v in (("<FeatDim>", cfg.feat_dim),
                       ("<NumSpeakers>", cfg.num_speakers),
                       ("<HiddenDim>", cfg.hidden_dim),
                       ("<EmbedDim>", cfg.embed_dim)):
            kio.write_token(f, tok)
            kio.write_basic_int32(f, int(v))
        kio.write_token(f, "<Contexts>")
        kio.write_basic_int32(f, len(cfg.contexts))
        for ctx in cfg.contexts:
            kio.write_int_vector(f, np.asarray(ctx, np.int32))
        kio.write_token(f, "<Spks>")
        kio.write_basic_int32(f, len(spk_list))
        for s in spk_list:
            kio.write_token(f, f"<{s}>")
        kio.write_token(f, "<Params>")
        write_pytree(f, state_dict_to_flax(model.state_dict()))
        kio.write_token(f, "</XvectorModel>")


# Port of kaldi_tpu/am/xvector.py load_xvector_model.
def load_xvector_model(path: str, device: torch.device | str = "cuda"
                       ) -> Tuple[XvectorNet, list]:
    """→ (XvectorNet in eval mode on ``device``, speaker list)."""
    from kaldi_tpu_torch.am.serialize import read_pytree
    from kaldi_tpu_torch.core import io as kio
    dev = resolve_device(device)
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<XvectorModel>")
        vals = {}
        for tok in ("<FeatDim>", "<NumSpeakers>", "<HiddenDim>",
                    "<EmbedDim>"):
            kio.expect_token(f, tok)
            vals[tok] = kio.read_basic_int32(f)
        kio.expect_token(f, "<Contexts>")
        n = kio.read_basic_int32(f)
        contexts = tuple(tuple(int(x) for x in kio.read_int_vector(f))
                         for _ in range(n))
        kio.expect_token(f, "<Spks>")
        ns = kio.read_basic_int32(f)
        spks = [kio.read_token(f)[1:-1] for _ in range(ns)]
        kio.expect_token(f, "<Params>")
        variables = read_pytree(f)
        kio.expect_token(f, "</XvectorModel>")
    cfg = XvectorConfig(feat_dim=vals["<FeatDim>"],
                        num_speakers=vals["<NumSpeakers>"],
                        hidden_dim=vals["<HiddenDim>"],
                        embed_dim=vals["<EmbedDim>"],
                        contexts=contexts)
    model = XvectorNet(cfg)
    model.load_state_dict(state_dict_from_flax(variables))
    return model.to(dev).eval(), spks
