"""Port of kaldi_tpu/am/nnet1.py. nnet1-era acoustic models: RBM
pretraining + sigmoid DNN.

Parity target: src/nnet/ ("Karel's" DNN).  Its distinguishing recipe
(steps/nnet/pretrain_dbn.sh + train.sh): stack restricted Boltzmann
machines trained layerwise by contrastive divergence (CD-1), then
fine-tune the unrolled sigmoid DNN with frame cross-entropy (and sMBR
sequence training — am/discriminative.py).

- First layer: Gaussian-Bernoulli RBM (real-valued inputs, unit
  variance assumed — inputs are globally CMVN'd, as in the recipe).
- Deeper layers: Bernoulli-Bernoulli on the previous layer's hidden
  probabilities.

``SigmoidDnn`` is an ``nn.Module`` whose modules are named as flax names
the original's (``hidden{i}``, ``output_affine``); its products are
``nn.Linear`` (torch.matmul), as the JAX package leaves them to XLA.
The parameter tree the tools and ``<Nnet1>`` files carry is flax's:
nested dicts of numpy arrays, kernels (in, out).  ``nnet1_model`` /
``nnet1_params`` carry it to the module and back.

Randomness: the RBM's initial weights and frame order, the fine-tuning
order and the output layer of ``dnn_params_from_dbn`` come from
``np.random.default_rng(seed)``, as in the original, so they are the
same bits.  CD-1's hidden-state samples compare uniform draws ``u`` with
the hidden probabilities; ``cd1_update`` takes ``u`` as an argument and
``train_rbm`` draws it through ``draw_uniform`` from a
``torch.Generator`` seeded by ``seed`` (the original's come from
``jax.random``, other bits; a test replays them by replacing
``draw_uniform``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/am/nnet1.py RbmParams.
@dataclasses.dataclass
class RbmParams:
    W: np.ndarray        # (vis, hid)
    vis_bias: np.ndarray
    hid_bias: np.ndarray
    gaussian_visible: bool = False


def draw_uniform(generator: torch.Generator, shape: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """One CD-1 step's uniform draws in [0, 1), float32 on ``device``,
    from ``generator`` (a generator of that device)."""
    return torch.rand(shape, generator=generator, device=device)


def cd1_update(rbm: Dict[str, torch.Tensor], v0: torch.Tensor,
               u: torch.Tensor, lr: float, gaussian_visible: bool
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One CD-1 step on a (B, vis) minibatch with the (B, hid) uniform
    draws ``u``.  Returns (new params, reconstruction MSE as a 0-d
    tensor).  Hidden states are sampled for the down pass
    (rbm-train-cd1-frmshuff semantics): h = 1 where u < P(h = 1);
    statistics use probabilities."""
    W, vb, hb = rbm["W"], rbm["vis_bias"], rbm["hid_bias"]
    h0_prob = torch.sigmoid(v0 @ W + hb)
    h0_samp = (u < h0_prob).to(v0.dtype)
    if gaussian_visible:
        v1 = h0_samp @ W.T + vb          # mean-field real visible
    else:
        v1 = torch.sigmoid(h0_samp @ W.T + vb)
    h1_prob = torch.sigmoid(v1 @ W + hb)
    B = v0.shape[0]
    dW = (v0.T @ h0_prob - v1.T @ h1_prob) / B
    dvb = torch.mean(v0 - v1, dim=0)
    dhb = torch.mean(h0_prob - h1_prob, dim=0)
    new = {"W": W + lr * dW, "vis_bias": vb + lr * dvb,
           "hid_bias": hb + lr * dhb}
    return new, torch.mean((v0 - v1) ** 2)


def train_rbm(data: np.ndarray, hid_dim: int, num_epochs: int = 4,
              batch_size: int = 256, lr: float = 0.05,
              gaussian_visible: bool = False, seed: int = 0,
              device: torch.device | str = "cuda"
              ) -> Tuple[RbmParams, List[float]]:
    """Train one RBM on (N, vis) frames on ``device``; returns params +
    per-epoch reconstruction errors (monotone decrease is the health
    check).  The frames go to the device once; each step gathers its
    minibatch there."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    vis = data.shape[1]
    rbm = {"W": torch.tensor((rng.standard_normal((vis, hid_dim)) * 0.01)
                             .astype(np.float32), device=device),
           "vis_bias": torch.zeros(vis, device=device),
           "hid_bias": torch.zeros(hid_dim, device=device)}
    frames = torch.tensor(np.asarray(data, np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    errs = []
    with torch.no_grad():
        for ep in range(num_epochs):
            order = torch.from_numpy(rng.permutation(len(data))).to(device)
            step_errs = []
            for i in range(0, len(data) - batch_size + 1, batch_size):
                v = frames[order[i:i + batch_size]]
                u = draw_uniform(gen, (batch_size, hid_dim), device)
                rbm, err = cd1_update(rbm, v, u, lr, gaussian_visible)
                step_errs.append(err)
            nb = len(step_errs)
            # the original adds the steps' errors as Python floats
            tot = (float(torch.stack(step_errs).double().sum())
                   if nb else 0.0)
            errs.append(tot / max(nb, 1))
            log.info("rbm: epoch %d recon mse %.4f", ep, errs[-1])
    return RbmParams(rbm["W"].cpu().numpy(), rbm["vis_bias"].cpu().numpy(),
                     rbm["hid_bias"].cpu().numpy(),
                     gaussian_visible=gaussian_visible), errs


def pretrain_dbn(frames: np.ndarray, hid_dims: Sequence[int],
                 num_epochs: int = 4, seed: int = 0,
                 device: torch.device | str = "cuda") -> List[RbmParams]:
    """steps/nnet/pretrain_dbn.sh: layerwise CD-1 stack on ``device``.
    frames is (N, feat_dim) spliced+normalized input."""
    device = resolve_device(device)
    rbms: List[RbmParams] = []
    h = np.asarray(frames, np.float32)
    for li, hd in enumerate(hid_dims):
        rbm, _ = train_rbm(h, hd, num_epochs=num_epochs,
                           gaussian_visible=(li == 0), seed=seed + li,
                           device=device)
        rbms.append(rbm)
        with torch.no_grad():
            h = torch.sigmoid(
                torch.from_numpy(h).to(device)
                @ torch.from_numpy(rbm.W).to(device)
                + torch.from_numpy(rbm.hid_bias).to(device)).cpu().numpy()
        log.info("dbn: layer %d pretrained (%d → %d)", li + 1,
                 rbm.W.shape[0], hd)
    return rbms


class SigmoidDnn(nn.Module):
    """The unrolled DBN + output layer: (..., D) → log-posteriors."""

    def __init__(self, in_dim: int, hid_dims: Sequence[int], num_pdfs: int):
        super().__init__()
        self.hid_dims = tuple(int(h) for h in hid_dims)
        self.num_pdfs = int(num_pdfs)
        d = int(in_dim)
        for i, hd in enumerate(self.hid_dims):
            setattr(self, f"hidden{i + 1}", nn.Linear(d, hd))
            d = hd
        self.output_affine = nn.Linear(d, self.num_pdfs)

    def forward(self, x):
        h = x
        for i in range(len(self.hid_dims)):
            h = torch.sigmoid(getattr(self, f"hidden{i + 1}")(h))
        return torch.log_softmax(self.output_affine(h), dim=-1)


def layer_names(hid_dims: Sequence[int]) -> Tuple[str, ...]:
    """Ordered top-level param-tree keys: hidden layers then output
    (the order of nnet-set-learnrate's factors)."""
    return tuple(f"hidden{i + 1}" for i in range(len(hid_dims))) \
        + ("output_affine",)


def nnet1_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """flax's parameter tree (numpy or jax arrays) → the state dict of a
    ``SigmoidDnn``: each kernel (in, out) as a weight (out, in).
    Copies (the tree is never shared with the module)."""
    sd = {}
    for name, dense in params.items():
        sd[f"{name}.weight"] = torch.tensor(
            np.asarray(dense["kernel"], np.float32).T.copy())
        sd[f"{name}.bias"] = torch.tensor(
            np.asarray(dense["bias"], np.float32))
    return sd


def nnet1_params(model: SigmoidDnn) -> Dict:
    """A ``SigmoidDnn``'s weights → flax's parameter tree (numpy,
    kernels (in, out))."""
    out = {}
    for name in layer_names(model.hid_dims):
        lin = getattr(model, name)
        out[name] = {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
                     "bias": lin.bias.detach().cpu().numpy().copy()}
    return out


def nnet1_model(params: Dict, hid_dims: Sequence[int], num_pdfs: int,
                device: torch.device | str = "cuda") -> SigmoidDnn:
    """The ``SigmoidDnn`` of ``params`` in eval mode on ``device``."""
    device = resolve_device(device)
    in_dim = np.asarray(params["hidden1" if len(hid_dims)
                               else "output_affine"]["kernel"]).shape[0]
    model = SigmoidDnn(in_dim, hid_dims, num_pdfs)
    model.load_state_dict(nnet1_state_dict(params))
    return model.eval().to(device)


def init_nnet1(in_dim: int, hid_dims: Sequence[int], num_pdfs: int,
               generator: torch.Generator) -> Dict:
    """Fresh parameters as flax initialises the original's ``SigmoidDnn``:
    every kernel from lecun_normal (drawn in layer order from
    ``generator``), biases zero.  flax's bits differ (its own RNG); only
    the distributions agree."""
    from kaldi_tpu_torch.am.tdnn import _lecun_normal_
    model = SigmoidDnn(in_dim, hid_dims, num_pdfs)
    with torch.no_grad():
        for name in layer_names(hid_dims):
            lin = getattr(model, name)
            _lecun_normal_(lin.weight, lin.in_features, generator)
            lin.bias.zero_()
    return nnet1_params(model)


# Copied from kaldi_tpu/am/nnet1.py dnn_params_from_dbn.
def dnn_params_from_dbn(rbms: Sequence[RbmParams], num_pdfs: int,
                        seed: int = 0) -> Dict:
    """Initialize SigmoidDnn params from the pretrained stack (the
    dbn → nnet init of steps/nnet/train.sh)."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, r in enumerate(rbms):
        params[f"hidden{i + 1}"] = {
            "kernel": np.asarray(r.W, np.float32),
            "bias": np.asarray(r.hid_bias, np.float32)}
    out_in = rbms[-1].W.shape[1]
    params["output_affine"] = {
        "kernel": (rng.standard_normal((out_in, num_pdfs)) * 0.01
                   ).astype(np.float32),
        "bias": np.zeros(num_pdfs, np.float32)}
    return params


def sgd_step(model: nn.Module, loss: torch.Tensor, lr: float,
             lr_factors: Optional[Dict[str, float]] = None) -> None:
    """Backpropagate ``loss`` and take optax's plain SGD step: each
    parameter p += -lr · (g · f), f its top-level layer's factor in
    ``lr_factors`` (default 1; 0 freezes the layer bit for bit)."""
    model.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = p.grad
            if lr_factors:
                g = g * float(lr_factors.get(name.split(".")[0], 1.0))
            p += g * (-lr)


def finetune_xent(params: Dict, hid_dims: Sequence[int], num_pdfs: int,
                  frames: np.ndarray, targets: np.ndarray,
                  num_epochs: int = 6, batch_size: int = 256,
                  lr: float = 0.5, seed: int = 0,
                  lr_factors: Optional[Dict[str, float]] = None,
                  device: torch.device | str = "cuda"
                  ) -> Tuple[Dict, float]:
    """Frame cross-entropy fine-tuning (nnet-train-frmshuff) on
    ``device``: plain SGD on shuffled frames, the nnet1 default.
    ``lr_factors`` maps top-level layer names to per-layer
    learning-rate multipliers (the nnet-set-learnrate contract); factor
    0 freezes a layer.  → (flax's tree of the trained model, the last
    step's loss)."""
    device = resolve_device(device)
    model = nnet1_model(params, hid_dims, num_pdfs, device).train()
    x_all = torch.tensor(np.asarray(frames, np.float32), device=device)
    y_all = torch.tensor(np.asarray(targets, np.int64), device=device)
    rng = np.random.default_rng(seed)
    batch_size = max(1, min(batch_size, len(frames)))
    loss = None
    for ep in range(num_epochs):
        order = torch.from_numpy(rng.permutation(len(frames))).to(device)
        losses = []
        for i in range(0, len(frames) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            logp = model(x_all[idx])
            loss = -torch.gather(logp, 1, y_all[idx, None]).mean()
            sgd_step(model, loss, lr, lr_factors)
            loss = loss.detach()
            losses.append(loss)
        tot = float(torch.stack(losses).double().sum()) if losses else 0.0
        log.info("nnet1: epoch %d xent %.4f", ep, tot / max(len(losses), 1))
    return nnet1_params(model), float(loss)


def save_nnet1(path: str, params, hid_dims: Sequence[int],
               num_pdfs: int,
               priors: Optional[np.ndarray] = None,
               lr_factors: Optional[np.ndarray] = None) -> None:
    """Serialize a SigmoidDnn (the nnet1 final.nnet role) from flax's
    parameter tree or the module: dims + params (+ optional class
    priors for nnet-forward's --class-frame-counts division; + optional
    per-layer learning-rate factors for [hidden1..hiddenN,
    output_affine] — the nnet-set-learnrate contract)."""
    from kaldi_tpu_torch.am.nnet2 import tree_map
    from kaldi_tpu_torch.am.serialize import write_pytree
    from kaldi_tpu_torch.core import io as kio
    if isinstance(params, nn.Module):
        params = nnet1_params(params)
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<Nnet1>")
        kio.write_basic_int32(f, len(hid_dims))
        for hd in hid_dims:
            kio.write_basic_int32(f, int(hd))
        kio.write_basic_int32(f, int(num_pdfs))
        kio.write_basic_int32(f, 1 if priors is not None else 0)
        if priors is not None:
            kio.write_vector(f, np.asarray(priors, np.float32))
        kio.write_token(f, "<Params>")
        write_pytree(f, tree_map(np.asarray, dict(params)))
        if lr_factors is not None:
            kio.write_token(f, "<LrFactors>")
            kio.write_vector(f, np.asarray(lr_factors, np.float32))
        kio.write_token(f, "</Nnet1>")


def load_nnet1(path: str):
    """→ (params, hid_dims, num_pdfs, priors-or-None).  See
    load_nnet1_full for the learning-rate factors."""
    params, hid_dims, num_pdfs, priors, _lr = load_nnet1_full(path)
    return params, hid_dims, num_pdfs, priors


# Copied from kaldi_tpu/am/nnet1.py load_nnet1_full.
def load_nnet1_full(path: str):
    """→ (params, hid_dims, num_pdfs, priors, lr_factors)."""
    from kaldi_tpu_torch.am.serialize import read_pytree
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<Nnet1>")
        n = kio.read_basic_int32(f)
        hid_dims = tuple(kio.read_basic_int32(f) for _ in range(n))
        num_pdfs = kio.read_basic_int32(f)
        priors = (np.asarray(kio.read_vector(f))
                  if kio.read_basic_int32(f) else None)
        kio.expect_token(f, "<Params>")
        params = read_pytree(f)
        lr_factors = None
        tok = kio.read_token(f)
        if tok == "<LrFactors>":
            lr_factors = np.asarray(kio.read_vector(f))
            tok = kio.read_token(f)
        if tok != "</Nnet1>":
            raise KaldiError(f"load_nnet1: unexpected token {tok}")
    return params, hid_dims, num_pdfs, priors, lr_factors
