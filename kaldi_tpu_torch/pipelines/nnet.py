# Port of kaldi_tpu/pipelines/nnet.py (flax + optax) to PyTorch.
"""Frame-level cross-entropy NN acoustic model training ('xent' systems).

Port of kaldi_tpu/pipelines/nnet.py (parity target: steps/nnet3/
train_dnn.py + nnet3-train): a TDNN-F on per-frame pdf targets from GMM
alignments, decoded with pseudo-log-likelihoods log p(pdf|x) −
log prior(pdf) (src/nnet3/decodable-simple-looped.h's convention).  The
model, the masked NLL, Adam (``torch.optim.Adam`` with optax's adam
settings: b1 0.9, b2 0.999, eps 1e-8) and the priors run on ``device``;
chunking and the epochs' numpy draws are the original's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig, init_tdnn
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/pipelines/nnet.py XentTrainConfig.
@dataclasses.dataclass
class XentTrainConfig:
    num_epochs: int = 20
    batch_size: int = 16
    chunk_size: int = 64
    learning_rate: float = 1e-3


# Port of kaldi_tpu/pipelines/nnet.py XentTrainer.
class XentTrainer:
    """Cross-entropy trainer over fixed chunks (subsampling factor 1)."""

    def __init__(self, model_cfg: TdnnConfig, cfg: XentTrainConfig = None,
                 seed: int = 0, device: torch.device | str = "cuda"):
        assert model_cfg.frame_subsampling_factor == 1, \
            "xent systems decode at the full frame rate"
        self.device = resolve_device(device)
        self.cfg = cfg or XentTrainConfig()
        self.model_cfg = model_cfg
        self.model = init_tdnn(TdnnChain(model_cfg), seed).to(self.device)
        self.num_pdfs = model_cfg.num_pdfs
        self.opt = torch.optim.Adam(self.model.parameters(),
                                    lr=self.cfg.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.log_priors = np.zeros(self.num_pdfs, np.float32)

    def _step(self, feats, targets, mask):
        """One Adam step on a batch (numpy or tensors): the masked mean
        NLL and the masked frame accuracy, in training mode (the batch
        norm statistics move).  → (loss, accuracy), detached tensors on
        the device."""
        dev = self.device
        feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
        targets = torch.as_tensor(targets).to(dev, torch.int64)
        mask = torch.as_tensor(mask).to(dev, torch.bool)
        self.model.train()
        logits = self.model(feats)
        lp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, 2, targets[..., None])[..., 0]
        n = torch.clamp(mask.sum(), min=1)
        loss = torch.where(mask, nll, torch.zeros_like(nll)).sum() / n
        with torch.no_grad():
            acc = ((logits.argmax(-1) == targets) & mask).sum() / n
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach(), acc

    # Copied from kaldi_tpu/pipelines/nnet.py XentTrainer.make_egs.
    def make_egs(self, feats: Dict[str, np.ndarray],
                 pdf_ali: Dict[str, np.ndarray]):
        C = self.cfg.chunk_size
        X, Y, M = [], [], []
        counts = np.zeros(self.num_pdfs)
        for u in sorted(feats):
            f = feats[u]
            a = np.asarray(pdf_ali[u])
            T = min(f.shape[0], len(a))
            counts += np.bincount(a[:T], minlength=self.num_pdfs)
            for s in range(0, T - C + 1, C):
                X.append(f[s:s + C])
                Y.append(a[s:s + C])
                M.append(np.ones(C, bool))
            rem = T % C
            if rem > C // 4:
                xf = np.zeros((C, f.shape[1]), f.dtype)
                xf[:rem] = f[T - rem:T]
                ya = np.zeros(C, np.int32)
                ya[:rem] = a[T - rem:T]
                m = np.zeros(C, bool)
                m[:rem] = True
                X.append(xf)
                Y.append(ya)
                M.append(m)
        # pdf priors from the alignment counts (nnet3-am-adjust-priors)
        priors = (counts + 0.5) / (counts.sum() + 0.5 * self.num_pdfs)
        self.log_priors = np.log(priors).astype(np.float32)
        return (np.stack(X).astype(np.float32),
                np.stack(Y).astype(np.int32), np.stack(M))

    def train(self, feats, pdf_ali) -> Dict[str, float]:
        X, Y, M = self.make_egs(feats, pdf_ali)
        N = X.shape[0]
        B = min(self.cfg.batch_size, N)
        rng = np.random.default_rng(0)
        out = {}
        for epoch in range(self.cfg.num_epochs):
            order = rng.permutation(N)
            for i in range(0, N - B + 1, B):
                idx = order[i:i + B]
                loss, acc = self._step(X[idx], Y[idx], M[idx])
            out = {"loss": float(loss), "frame_acc": float(acc)}
            if epoch % 5 == 0 or epoch == self.cfg.num_epochs - 1:
                log.info("xent epoch %d: loss %.4f acc %.3f", epoch,
                         out["loss"], out["frame_acc"])
        return out

    def loglikes_fn(self):
        """(T, D) → (T, P) pseudo-loglikes on the device: log-softmax −
        log-priors, the model in eval mode."""
        model = self.model
        log_priors = torch.from_numpy(self.log_priors).to(self.device)

        def f(feats):
            model.eval()
            x = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
            with torch.no_grad():
                logits = model(x[None])[0]
            return torch.log_softmax(logits, dim=-1) - log_priors[None, :]

        return f
