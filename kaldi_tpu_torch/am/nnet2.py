"""Port of kaldi_tpu/am/nnet2.py. nnet2-era acoustic models: p-norm
networks and parallel SGD with model averaging.

Parity target: src/nnet2/ ("Dan's" first NN framework): the p-norm
nonlinearity (``PnormComponent`` + ``NormalizeComponent``,
src/nnet2/nnet-component.h), the mixed-up softmax
(``SoftmaxComponent::MixUp``) and the outer loop of
steps/nnet2/train_pnorm_fast.sh (N jobs from a common start, then the
parameter average of nnet-am-average).

``Nnet2Model`` is an ``nn.Module`` whose modules are named as flax names
the original's (``pnorm{i}.affine``, ``output_affine``); its affine
products are ``nn.Linear`` (torch.matmul), as the JAX package leaves
them to XLA.  The parameter tree the tools and files carry is flax's:
nested dicts of numpy arrays, dense kernels (in, out).
``nnet2_state_dict`` / ``nnet2_params`` carry it to the module
(``nn.Linear.weight`` is (out, in)) and back, and ``save_nnet2`` /
``load_nnet2_full`` write and read the original's ``<Nnet2>`` file from
it, byte for byte.  The mixed-up softmax's grouped sums go through
``index_add_`` (the original's one-hot product, which a TF32 product
would round).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


def pnorm(x: torch.Tensor, output_dim: int, p: float = 2.0) -> torch.Tensor:
    """Grouped p-norm: input dim must be a multiple of output_dim;
    each output pools group_size consecutive inputs."""
    D = x.shape[-1]
    if D % output_dim:
        raise ValueError(f"pnorm: input dim {D} not a multiple of "
                         f"output dim {output_dim}")
    xg = x.reshape(x.shape[:-1] + (output_dim, D // output_dim))
    if p == 2.0:
        return torch.sqrt(torch.sum(xg * xg, dim=-1) + 1e-20)
    return torch.pow(torch.sum(torch.pow(torch.abs(xg), p), dim=-1) + 1e-20,
                     1.0 / p)


def normalize_rms(x: torch.Tensor, target_rms: float = 1.0) -> torch.Tensor:
    """NormalizeComponent: scale each frame so its root-mean-square is
    target_rms (the reference's scale = target_rms·√D / ‖x‖)."""
    D = x.shape[-1]
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-20)
    return x * (target_rms * float(np.sqrt(float(D))) / norm)


class PnormLayer(nn.Module):
    """Affine → pnorm → normalize (one hidden layer of the
    train_pnorm_fast.sh architecture)."""

    def __init__(self, in_dim: int, pnorm_input_dim: int,
                 pnorm_output_dim: int, p: float = 2.0):
        super().__init__()
        self.affine = nn.Linear(in_dim, pnorm_input_dim)
        self.pnorm_output_dim = pnorm_output_dim
        self.p = p

    def forward(self, x):
        h = pnorm(self.affine(x), self.pnorm_output_dim, self.p)
        return normalize_rms(h)


# Copied from kaldi_tpu/am/nnet2.py Nnet2Config.
@dataclasses.dataclass
class Nnet2Config:
    feat_dim: int = 40
    num_pdfs: int = 128
    num_hidden_layers: int = 3
    pnorm_input_dim: int = 800
    pnorm_output_dim: int = 160
    splice: Tuple[int, ...] = (-2, -1, 0, 1, 2)
    p: float = 2.0
    # "mixed-up" softmax (SoftmaxComponent::MixUp,
    # src/nnet2/nnet-component.h): the output affine has
    # len(mix2pdf) >= num_pdfs rows; posteriors of rows mapped to the
    # same pdf are summed (log-domain: grouped logsumexp of logits)
    mix2pdf: Optional[Tuple[int, ...]] = None
    # nnet-am-switch-preconditioning flag: trainers consult this to
    # use the NG-SGD preconditioner instead of plain SGD
    preconditioned: bool = False
    # per-layer learning rates (hidden layers then output affine), set
    # by nnet-modify-learning-rates (src/nnet2/nnet-nnet.h
    # SetLearningRates role); trainers scale each layer's update by
    # learn_rates[i] / base_lr when present
    learn_rates: Optional[Tuple[float, ...]] = None


class Nnet2Model(nn.Module):
    """(B, T, feat_dim) → (B, T, num_pdfs) log-softmax posteriors.
    Input already spliced (B, T, feat_dim · len(splice)), as egs carry
    it, skips the model's own splice."""

    def __init__(self, config: Nnet2Config):
        super().__init__()
        cfg = self.config = config
        in_dim = cfg.feat_dim * len(cfg.splice)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"pnorm{i + 1}",
                    PnormLayer(in_dim, cfg.pnorm_input_dim,
                               cfg.pnorm_output_dim, cfg.p))
            in_dim = cfg.pnorm_output_dim
        rows = cfg.num_pdfs if cfg.mix2pdf is None else len(cfg.mix2pdf)
        self.output_affine = nn.Linear(in_dim, rows)
        self.register_buffer(
            "mix2pdf", None if cfg.mix2pdf is None else
            torch.tensor(cfg.mix2pdf, dtype=torch.int64), persistent=False)

    def forward(self, x):
        from kaldi_tpu_torch.am.tdnn import splice
        cfg = self.config
        # egs carry pre-spliced windows (nnet-get-egs does the
        # splicing, the upstream contract) — detect by dim and skip
        # the model-side splice then
        if x.shape[-1] == cfg.feat_dim * len(cfg.splice) \
                and len(cfg.splice) > 1:
            h = x
        else:
            h = splice(x, cfg.splice)
        for i in range(cfg.num_hidden_layers):
            h = getattr(self, f"pnorm{i + 1}")(h)
        h = self.output_affine(h)
        if self.mix2pdf is not None:
            # grouped logsumexp over mixture rows per pdf, max-shifted
            mx = torch.max(h, dim=-1, keepdim=True).values
            e = torch.exp(h - mx)
            s = torch.zeros(h.shape[:-1] + (cfg.num_pdfs,), dtype=h.dtype,
                            device=h.device).index_add_(-1, self.mix2pdf, e)
            h = torch.log(torch.clamp_min(s, 1e-30)) + mx
        return torch.log_softmax(h, dim=-1)


def layer_names(cfg: Nnet2Config) -> Tuple[str, ...]:
    """Ordered top-level param-tree keys: hidden layers then output."""
    return tuple(f"pnorm{i + 1}" for i in range(cfg.num_hidden_layers)) \
        + ("output_affine",)


def _dense_of(params: Dict, name: str) -> Dict:
    return params[name] if name == "output_affine" \
        else params[name]["affine"]


def nnet2_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """flax's parameter tree (numpy or jax arrays) → the state dict of
    an ``Nnet2Model``: each kernel (in, out) as a weight (out, in).
    Copies (the tree is never shared with the module)."""
    sd = {}
    for name in params:
        prefix = "output_affine" if name == "output_affine" \
            else f"{name}.affine"
        dense = _dense_of(params, name)
        sd[f"{prefix}.weight"] = torch.tensor(
            np.asarray(dense["kernel"], np.float32).T.copy())
        sd[f"{prefix}.bias"] = torch.tensor(
            np.asarray(dense["bias"], np.float32))
    return sd


def nnet2_params(model: Nnet2Model) -> Dict:
    """An ``Nnet2Model``'s weights → flax's parameter tree (numpy,
    kernels (in, out))."""
    out = {}
    for name in layer_names(model.config):
        mod = getattr(model, name)
        lin = mod if name == "output_affine" else mod.affine
        dense = {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
                 "bias": lin.bias.detach().cpu().numpy().copy()}
        out[name] = dense if name == "output_affine" \
            else {"affine": dense}
    return out


def nnet2_model(params: Dict, cfg: Nnet2Config,
                device: torch.device | str = "cuda") -> Nnet2Model:
    """The ``Nnet2Model`` of ``params`` in eval mode on ``device``."""
    device = resolve_device(device)
    model = Nnet2Model(cfg)
    model.load_state_dict(nnet2_state_dict(params))
    return model.eval().to(device)


def init_nnet2(cfg: Nnet2Config, generator: torch.Generator) -> Dict:
    """Fresh parameters as flax initialises the original's: every dense
    kernel from lecun_normal (drawn in layer order from ``generator``),
    biases zero.  flax's bits differ (its own RNG); only the
    distributions agree."""
    from kaldi_tpu_torch.am.tdnn import _lecun_normal_
    model = Nnet2Model(cfg)
    with torch.no_grad():
        for name in layer_names(cfg):
            mod = getattr(model, name)
            lin = mod if name == "output_affine" else mod.affine
            _lecun_normal_(lin.weight, lin.in_features, generator)
            lin.bias.zero_()
    return nnet2_params(model)


def log_priors(priors) -> np.ndarray:
    """An am-nnet's prior vector → the float32 log-priors the decodes
    subtract (normalized, floored at 1e-20), as the original's tools
    compute them."""
    pr = np.asarray(priors, np.float64)
    return np.log(np.maximum(pr / pr.sum(), 1e-20)).astype(np.float32)


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped nested dicts."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree, path=()):
    """(key path, leaf) of a nested dict in sorted key order, as jax's
    tree flattening visits a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def train_parallel_averaging(cfg: Nnet2Config,
                             feats: np.ndarray, targets: np.ndarray,
                             num_jobs: int = 4, num_iters: int = 10,
                             learning_rate: float = 2e-3,
                             seed: int = 0,
                             params: Optional[Dict] = None,
                             generator: Optional[torch.Generator] = None,
                             device: torch.device | str = "cuda"
                             ) -> Tuple[Dict, Dict[str, float]]:
    """The nnet2 outer loop: each iteration, `num_jobs` SGD workers
    start from the SAME parameters, each takes one pass over its own
    data shard (minibatches of 8 chunks), and the next iteration starts
    from the parameter average (nnet-am-average).  feats (N, T, D),
    targets (N, T) int.  The start is ``params`` (flax's tree) when
    given, else ``init_nnet2`` from ``generator`` (default: seeded by
    ``seed``).  The jobs run in turn on ``device``.

    Returns (params, diagnostics)."""
    device = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        params = init_nnet2(cfg, generator)
    model = nnet2_model(params, cfg, device).train()
    N = feats.shape[0]
    if N % num_jobs:
        keep = N - (N % num_jobs)
        feats, targets = feats[:keep], targets[:keep]
    fshard = torch.tensor(np.asarray(feats, np.float32), device=device
                          ).reshape(num_jobs, -1, *feats.shape[1:])
    tshard = torch.tensor(np.asarray(targets, np.int64), device=device
                          ).reshape(num_jobs, -1, *targets.shape[1:])

    def job_pass(f, t):
        job = copy.deepcopy(model)
        nb = max(f.shape[0] // 8, 1)
        losses = []
        for i in range(nb):
            fb, tb = f[i * 8:(i + 1) * 8], t[i * 8:(i + 1) * 8]
            logp = job(fb)
            loss = -torch.gather(logp, -1, tb[..., None]).mean()
            job.zero_grad()
            loss.backward()
            with torch.no_grad():
                for p in job.parameters():
                    p -= learning_rate * p.grad
            losses.append(loss.detach())
        return job.state_dict(), torch.stack(losses).mean()

    loss = None
    for it in range(num_iters):
        sds, job_losses = zip(*[job_pass(fshard[j], tshard[j])
                                for j in range(num_jobs)])
        with torch.no_grad():
            model.load_state_dict({k: torch.stack([sd[k] for sd in sds]
                                                  ).mean(dim=0)
                                   for k in sds[0]})
        loss = float(torch.stack(job_losses).mean())
        log.info("nnet2 iter %d: %d jobs averaged, xent %.4f", it,
                 num_jobs, loss)
    return nnet2_params(model), {"xent": loss}


def scale_updates_per_layer(updates: Dict, cfg: Nnet2Config,
                            base_lr: float) -> Dict:
    """Apply cfg.learn_rates (nnet-modify-learning-rates output) to an
    update tree (layer name → arrays or tensors) computed with a uniform
    base_lr."""
    if cfg.learn_rates is None:
        return updates
    names = layer_names(cfg)
    scale = {n: float(cfg.learn_rates[i]) / base_lr
             for i, n in enumerate(names) if i < len(cfg.learn_rates)}
    return {k: tree_map(lambda u, s=scale.get(k, 1.0): u * s, v)
            for k, v in updates.items()}


def save_nnet2(path: str, params, cfg: Nnet2Config,
               priors: Optional[np.ndarray] = None) -> None:
    """Serialize an Nnet2Model (the nnet2 final.mdl raw-net part) from
    flax's parameter tree or the module.  `priors` is the AmNnet prior
    vector (src/nnet2/am-nnet.h) used to turn posteriors into
    pseudo-loglikelihoods at decode time."""
    from kaldi_tpu_torch.am.serialize import write_pytree
    from kaldi_tpu_torch.core import io as kio
    if isinstance(params, nn.Module):
        params = nnet2_params(params)
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<Nnet2>")
        for v in (cfg.feat_dim, cfg.num_pdfs, cfg.num_hidden_layers,
                  cfg.pnorm_input_dim, cfg.pnorm_output_dim):
            kio.write_basic_int32(f, int(v))
        kio.write_basic_float(f, float(cfg.p))
        kio.write_int_vector(f, np.asarray(cfg.splice, np.int32))
        kio.write_token(f, "<Params>")
        write_pytree(f, tree_map(np.asarray, dict(params)))
        if cfg.mix2pdf is not None:
            kio.write_token(f, "<Mix2Pdf>")
            kio.write_int_vector(f, np.asarray(cfg.mix2pdf, np.int32))
        if cfg.preconditioned:
            kio.write_token(f, "<Preconditioned>")
        if cfg.learn_rates is not None:
            kio.write_token(f, "<LearnRates>")
            kio.write_vector(f, np.asarray(cfg.learn_rates, np.float32))
        if priors is not None:
            kio.write_token(f, "<Priors>")
            kio.write_vector(f, np.asarray(priors, np.float32))
        kio.write_token(f, "</Nnet2>")


# Copied from kaldi_tpu/am/nnet2.py load_nnet2_full.
def load_nnet2_full(path: str):
    """→ (params, Nnet2Config, priors-or-None)."""
    from kaldi_tpu_torch.am.serialize import read_pytree
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<Nnet2>")
        feat_dim = kio.read_basic_int32(f)
        num_pdfs = kio.read_basic_int32(f)
        nh = kio.read_basic_int32(f)
        pin = kio.read_basic_int32(f)
        pout = kio.read_basic_int32(f)
        p = kio.read_basic_float(f)
        splice = tuple(int(x) for x in kio.read_int_vector(f))
        kio.expect_token(f, "<Params>")
        params = read_pytree(f)
        mix2pdf = None
        precond = False
        priors = None
        learn_rates = None
        while True:
            tok = kio.read_token(f)
            if tok == "</Nnet2>":
                break
            if tok == "<Mix2Pdf>":
                mix2pdf = tuple(int(x) for x in kio.read_int_vector(f))
            elif tok == "<Preconditioned>":
                precond = True
            elif tok == "<LearnRates>":
                learn_rates = tuple(float(x) for x in kio.read_vector(f))
            elif tok == "<Priors>":
                priors = kio.read_vector(f)
            else:
                raise ValueError(f"load_nnet2: unexpected token {tok}")
    cfg = Nnet2Config(feat_dim=feat_dim, num_pdfs=num_pdfs,
                      num_hidden_layers=nh, pnorm_input_dim=pin,
                      pnorm_output_dim=pout, splice=splice, p=p,
                      mix2pdf=mix2pdf, preconditioned=precond,
                      learn_rates=learn_rates)
    return params, cfg, priors


def load_nnet2(path: str):
    """→ (params, Nnet2Config).  See load_nnet2_full for priors."""
    params, cfg, _priors = load_nnet2_full(path)
    return params, cfg
