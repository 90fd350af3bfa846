# Port of kaldi_tpu/pipelines/discriminative.py (jax + optax) to PyTorch.
"""Discriminative (sequence) fine-tuning of a trained NN acoustic
model: MMI or sMBR over decoder-generated denominator lattices.

Parity target: the nnet3 discriminative-training flow
(steps/nnet3/get_degs.sh + nnet3-discriminative-train: decode training
data with a weak LM → den lattices; numerator = forced alignment;
a few epochs of sequence-objective updates at a small lr) and nnet1's
sMBR recipe (steps/nnet/train_mpe.sh).

The lattices are generated ONCE with the starting model (matching the
reference, which fixes degs for all iterations) and converted to the
dense time-synchronous form of am/discriminative.py on the host, then
moved to the trainer's device once.  Each update is one utterance: the
model's forward in eval mode, log-softmax − log-priors (the scores the
decoder consumed), the objective's frame loop, autograd and one
``torch.optim.Adam`` step (optax.adam's update: b1 0.9, b2 0.999, eps
1e-8, no weight decay), all on the trainer's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from kaldi_tpu_torch.am.discriminative import (DenseLattice,
                                               den_lattice_from_decoder,
                                               frame_accuracy, lattice_to,
                                               mmi_objf, smbr_objf)
from kaldi_tpu_torch.core.logging import get_logger

log = get_logger(__name__)


# Copied from kaldi_tpu/pipelines/discriminative.py DiscriminativeConfig.
@dataclasses.dataclass
class DiscriminativeConfig:
    criterion: str = "smbr"           # "smbr" | "mmi"
    num_epochs: int = 4
    learning_rate: float = 5e-5
    acoustic_scale: float = 0.1


# Copied from kaldi_tpu/pipelines/discriminative.py make_degs.
def make_degs(decoder, scores: Dict[str, np.ndarray]
              ) -> Dict[str, DenseLattice]:
    """Denominator lattices for every utterance from the CURRENT model
    scores (get_degs.sh role).  Shapes (A, K) are padded to the corpus
    max (the original's shared compiled update; here they change
    nothing: padded arcs are masked)."""
    lats = {u: den_lattice_from_decoder(decoder, s)
            for u, s in scores.items()}
    A = max(l.src.shape[1] for l in lats.values())
    K = max(l.K for l in lats.values())

    def pad(l: DenseLattice) -> DenseLattice:
        T, a = l.src.shape

        def pa(x, fill=0):
            out = np.full((T, A), fill, x.dtype)
            out[:, :a] = x
            return out

        final = np.full(K, -1e30, np.float32)
        final[:l.K] = l.final
        return DenseLattice(src=pa(l.src), dst=pa(l.dst), pdf=pa(l.pdf),
                            w=pa(l.w), mask=pa(l.mask), final=final,
                            num_states=l.num_states)

    return {u: pad(l) for u, l in lats.items()}


def utterance_tensors(feats, num_ali, lat: DenseLattice, acc, device):
    """One utterance's inputs to ``sequence_step``, each on ``device``:
    (feats, numerator pdfs, per-arc accuracies — zeros when ``acc`` is
    None, as MMI wants —, the dense lattice)."""
    if acc is None:
        acc = np.zeros(lat.src.shape, np.float32)
    return (torch.as_tensor(np.asarray(feats, np.float32)).to(device),
            torch.as_tensor(np.asarray(num_ali)).to(device, torch.int64),
            torch.as_tensor(acc).to(device), lattice_to(lat, device))


def eg_tensors(eg, criterion: str, device):
    """A DiscEg → ``utterance_tensors`` (sMBR's accuracies from the host
    lattice, MMI's zeros, as the original)."""
    lat = eg.dense_lattice()
    acc = frame_accuracy(lat, eg.num_ali) if criterion == "smbr" else None
    return utterance_tensors(eg.feats, eg.num_ali, lat, acc, device)


def sequence_objf(criterion: str, lat: DenseLattice, scores: torch.Tensor,
                  num, acc, kappa: float) -> torch.Tensor:
    """The per-utterance objective to maximise: MMI or sMBR."""
    if criterion == "mmi":
        return mmi_objf(lat, scores, num, kappa)
    return smbr_objf(lat, scores, acc, kappa)


def sequence_step(model, opt, criterion: str, x: torch.Tensor,
                  num: torch.Tensor, acc: torch.Tensor, lat: DenseLattice,
                  kappa: float, log_priors: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One utterance's update: the model in eval mode (batch norm's
    statistics fixed, as the original's ``train=False``), scores =
    log-softmax (− log-priors when given), −objf's gradient, one
    optimizer step.  → the objective before the step (a detached
    tensor on the device)."""
    model.eval()
    logits = model(x[None])[0]
    scores = torch.log_softmax(logits, dim=-1)
    if log_priors is not None:
        scores = scores - log_priors[None, :]
    objf = sequence_objf(criterion, lat, scores, num, acc, kappa)
    opt.zero_grad(set_to_none=True)
    (-objf).backward()
    opt.step()
    return objf.detach()


def adam(model, learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate)'s update as torch's Adam."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


# Port of kaldi_tpu/pipelines/discriminative.py discriminative_finetune.
def discriminative_finetune(trainer, decoder, feats: Dict[str, np.ndarray],
                            num_ali: Dict[str, np.ndarray],
                            cfg: DiscriminativeConfig = None,
                            pdf_to_phone: Optional[np.ndarray] = None):
    """Fine-tune `trainer` (an XentTrainer: ``.model`` on ``.device``,
    ``.log_priors``, ``.loglikes_fn()``) on its own decode lattices.
    num_ali maps utt → per-frame pdf alignment.  Returns a dict of
    per-epoch mean objective values."""
    cfg = cfg or DiscriminativeConfig()
    dev = trainer.device
    scorer = trainer.loglikes_fn()
    scores0 = {u: scorer(feats[u]) for u in feats}
    degs = make_degs(decoder, scores0)
    accs = {u: frame_accuracy(degs[u], num_ali[u], pdf_to_phone)
            for u in feats} if cfg.criterion == "smbr" else {}

    model = trainer.model
    opt = adam(model, cfg.learning_rate)
    kappa = cfg.acoustic_scale
    log_priors = torch.from_numpy(
        np.asarray(trainer.log_priors, np.float32)).to(dev)
    # each utterance's tensors go to the device once
    data = {u: utterance_tensors(feats[u], num_ali[u][:degs[u].T], degs[u],
                                 accs.get(u), dev) for u in sorted(feats)}

    hist = []
    for ep in range(cfg.num_epochs):
        tot, n = 0.0, 0
        for u in sorted(feats):
            x, num, acc, lat = data[u]
            tot += float(sequence_step(model, opt, cfg.criterion, x, num,
                                       acc, lat, kappa, log_priors))
            n += 1
        hist.append(tot / max(n, 1))
        log.info("discriminative %s epoch %d: objf/utt %.4f",
                 cfg.criterion, ep, hist[-1])
    return {"objf": hist}
