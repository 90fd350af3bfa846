# Port of kaldi_tpu/lm/rnnlm.py (flax + optax) to PyTorch.
"""Recurrent neural network language model + lattice rescoring adapter.

Parity targets: src/rnnlm/ (RnnlmCoreTrainer, SamplingLm, and the
KaldiRnnlmDeterministicFst lattice-rescoring adapter — an on-demand
deterministic FST over RNNLM states).  The reference trains with
importance sampling to handle large vocabularies; the equivalent here is
a sampled softmax: per step a shared candidate set is drawn on the
device by Gumbel top-k from a unigram-power proposal, and the output
product runs over the K gathered rows plus the target's instead of V.
Pass sample_k to train_rnnlm to enable; full softmax remains the
default (and the test oracle) for small vocabularies.

The model is the original's flax one, parameter for parameter: an
embedding, a flax ``GRUCell`` (no bias on the ``hr``/``hz`` products,
unlike ``torch.nn.GRUCell``) and an output layer, each kernel laid out
(in, out) as flax keeps it.  The recurrence runs as one input product
over all frames, then one product of the three recurrent kernels a
frame.  ``params_from_flax`` / ``params_to_flax`` convert between the
original's parameter tree and the module's state dict, and the model
file is the original's (a flax msgpack payload, written and read by
core/msgpack.py), so each side reads the other's files.

Signature differences from the original: the module holds its
parameters, so ``train_rnnlm`` and ``load_rnnlm`` return the ``RnnLm``
(on ``device``, default the card) and ``perplexity``, ``RnnLmScorer``
and ``save_rnnlm`` take it in place of (params, model);
``train_rnnlm(stats=)`` fills a dict with the steps, the final epoch's
nll per word and the training seconds; ``RnnLmScorer`` runs its GRU
steps on ``device`` and counts them (``steps``).  Random draws come from
``torch.Generator``s seeded by ``seed``: the initial weights follow
flax's distributions, not its bits, and the sampled softmax's candidates
come from ``draw_candidates``.

RnnLmScorer is the ConstArpa-shaped interface lattice/rescore.compose_lm
consumes: score(history, word) with an internal cache of RNN states
keyed by history prefix — exactly how the reference's deterministic FST
memoizes states per lattice path.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core import msgpack
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.fst.fst import SymbolTable

log = get_logger(__name__)

# the std of a normal truncated at ±2 (flax's variance_scaling divides
# its scale by it)
_TRUNC_STD = .87962566103423978
# flax GRUCell's dense layers: (name, input side?, has a bias?)
GRU_DENSES = (("ir", True, True), ("iz", True, True), ("in", True, True),
              ("hr", False, False), ("hz", False, False), ("hn", False, True))


@dataclasses.dataclass
class RnnLmConfig:
    vocab_size: int = 100
    embed_dim: int = 64
    hidden_dim: int = 128


class _Dense(nn.Module):
    """flax ``Dense``'s parameters: ``kernel`` (in, out), ``bias``."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        if bias:
            self.bias = nn.Parameter(torch.zeros(n_out))
        else:
            self.register_parameter("bias", None)


class _Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))


class FlaxGru(nn.Module):
    """flax's ``GRUCell`` scanned over time:
    r = σ(x·W_ir + b_ir + h·W_hr), z = σ(x·W_iz + b_iz + h·W_hz),
    n = tanh(x·W_in + b_in + r ⊙ (h·W_hn + b_hn)),
    h' = (1 − z) ⊙ n + z ⊙ h."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for name, inp, bias in GRU_DENSES:
            self.add_module(name, _Dense(n_in if inp else hidden, hidden,
                                         bias))

    def packed(self):
        """(W_i (in, 3H), b_i (3H,), W_h (H, 3H), b_h (3H,)): the gates'
        kernels side by side in the order r, z, n; b_h is zero but for
        b_hn (built here, not a parameter)."""
        d = dict(self.named_children())
        w_i = torch.cat([d[n].kernel for n in ("ir", "iz", "in")], dim=1)
        b_i = torch.cat([d[n].bias for n in ("ir", "iz", "in")])
        w_h = torch.cat([d[n].kernel for n in ("hr", "hz", "hn")], dim=1)
        b_h = torch.cat([torch.zeros(2 * self.hidden, dtype=w_h.dtype,
                                     device=w_h.device), d["hn"].bias])
        return w_i, b_i, w_h, b_h

    @staticmethod
    def cell(xi: torch.Tensor, h: torch.Tensor, w_h: torch.Tensor,
             b_h: torch.Tensor) -> torch.Tensor:
        """One step from the input products ``xi`` (.., 3H) = x·W_i + b_i."""
        H = h.shape[-1]
        hh = torch.addmm(b_h, h, w_h)
        rz = torch.sigmoid(xi[..., :2 * H] + hh[..., :2 * H])
        r, z = rz[..., :H], rz[..., H:]
        n = torch.tanh(xi[..., 2 * H:] + r * hh[..., 2 * H:])
        return (1.0 - z) * n + z * h

    def forward(self, x: torch.Tensor, h: torch.Tensor):
        """x (B, T, in), h (B, H) → (hidden states (B, T, H), last h)."""
        w_i, b_i, w_h, b_h = self.packed()
        xi = x @ w_i + b_i
        hs = []
        for t in range(x.shape[1]):
            h = self.cell(xi[:, t], h, w_h, b_h)
            hs.append(h)
        return torch.stack(hs, dim=1), h


class RnnLm(nn.Module):
    def __init__(self, config: RnnLmConfig):
        super().__init__()
        self.config = config
        self.embed = _Embed(config.vocab_size, config.embed_dim)
        self.gru = FlaxGru(config.embed_dim, config.hidden_dim)
        self.output = _Dense(config.hidden_dim, config.vocab_size)

    def encode(self, tokens: torch.Tensor, carry=None):
        """tokens (B, T) int → (hidden states (B, T, H), final carry)."""
        emb = F.embedding(tokens, self.embed.embedding)
        if carry is None:
            carry = emb.new_zeros((tokens.shape[0],
                                   self.config.hidden_dim))
        return self.gru(emb, carry)

    def forward(self, tokens: torch.Tensor, carry=None):
        """tokens (B, T) int → (logits (B, T, V), final carry)."""
        hs, carry = self.encode(tokens, carry)
        return hs @ self.output.kernel + self.output.bias, carry


def init_rnnlm(model: RnnLm, seed: int = 0) -> RnnLm:
    """Fresh weights drawn as flax initialises the original: the
    embedding from ``nn.Embed``'s default (a normal of variance 1/E),
    the input and output kernels from lecun_normal (a normal truncated
    at ±2, scaled to variance 1/fan_in), the recurrent kernels
    orthogonal, biases zero.
    flax's bits differ (its own RNG); only the distributions agree."""
    gen = torch.Generator().manual_seed(seed)

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        w = torch.empty(p.shape)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        p.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))

    with torch.no_grad():
        emb = torch.empty(model.embed.embedding.shape)
        nn.init.normal_(emb, 0.0, 1.0, generator=gen)
        model.embed.embedding.copy_(emb / math.sqrt(model.config.embed_dim))
        for name, inp, _ in GRU_DENSES:
            d = getattr(model.gru, name)
            if inp:
                lecun(d.kernel, d.kernel.shape[0])
            else:
                w = torch.empty(d.kernel.shape)
                nn.init.orthogonal_(w, generator=gen)
                d.kernel.copy_(w)
            if d.bias is not None:
                d.bias.zero_()
        lecun(model.output.kernel, model.config.hidden_dim)
        model.output.bias.zero_()
    return model


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """The original's flax parameter tree (leaves as numpy arrays) → an
    ``RnnLm`` state dict (the same arrays, copied)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, prefix + k + ".")
            else:
                # a copy: the tree's arrays may share memory with a JAX
                # buffer
                sd[prefix + k] = torch.tensor(np.asarray(v, np.float32))

    walk(params, "")
    return sd


def params_to_flax(model: RnnLm) -> Dict[str, dict]:
    """An ``RnnLm``'s parameters as the original's flax tree of numpy
    float32 arrays, keys sorted at every level (as a trained flax tree
    comes out of jax's tree maps)."""
    tree: Dict[str, dict] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy().astype(np.float32)

    def sort(d):
        return {k: sort(d[k]) if isinstance(d[k], dict) else d[k]
                for k in sorted(d)}
    return sort(tree)


# Port of kaldi_tpu/lm/rnnlm.py unigram_proposal (copied).
def unigram_proposal(sentences: Sequence[Sequence[int]], vocab_size: int,
                     power: float = 0.75, eos: int = 2) -> np.ndarray:
    """Unigram^power proposal distribution for importance sampling — the
    SamplingLm role (src/rnnlm/sampling-lm.h estimates a backoff LM to
    propose negative samples; a flattened unigram is the standard
    static-proposal variant and keeps the draw fully on device)."""
    counts = np.ones(vocab_size, np.float64)      # add-1: all words live
    for s in sentences:
        for w in s:
            counts[w] += 1
        counts[eos] += 1
    q = counts ** power
    return (q / q.sum()).astype(np.float32)


def draw_candidates(log_q: torch.Tensor, k: int,
                    generator: torch.Generator) -> torch.Tensor:
    """K shared candidates drawn from q without replacement: Gumbel top-k
    over log q (the original's ``jax.random.gumbel`` + ``lax.top_k``),
    on log_q's device.  → (K,) int64."""
    u = torch.rand(log_q.shape, generator=generator, device=log_q.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(
        torch.finfo(log_q.dtype).tiny)))
    return torch.topk(log_q + gumbel, k).indices


def _masked_mean(nll: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (torch.where(mask, nll, 0.0).sum()
            / torch.clamp(mask.sum(), min=1))


def full_softmax_loss(model: RnnLm, xi, xt, xm) -> torch.Tensor:
    """Mean nll per target word over the mask, by the full softmax."""
    logits, _ = model(xi)
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, 2, xt[..., None])[..., 0]
    return _masked_mean(nll, xm)


def sampled_softmax_loss(model: RnnLm, xi, xt, xm, log_q: torch.Tensor,
                         cand: torch.Tensor) -> torch.Tensor:
    """The original's sampled softmax: logits over the K candidates and
    the target, each corrected by log(K·q), accidental hits (a candidate
    equal to the target) masked to −inf."""
    k = float(cand.shape[0])
    hs, _ = model.encode(xi)
    W, b = model.output.kernel, model.output.bias          # (H, V), (V,)
    corr_c = math.log(k) + log_q[cand]
    logits_c = hs @ W[:, cand] + b[cand] - corr_c          # (B, T, K)
    corr_t = math.log(k) + log_q[xt]
    logit_t = (hs * W.t()[xt]).sum(-1) + b[xt] - corr_t    # (B, T)
    hit = cand[None, None, :] == xt[..., None]
    logits_c = torch.where(hit, float("-inf"), logits_c)
    denom = torch.logaddexp(logit_t, torch.logsumexp(logits_c, dim=-1))
    return _masked_mean(denom - logit_t, xm)


def train_step(model: RnnLm, opt: torch.optim.Optimizer, xi, xt, xm,
               log_q: Optional[torch.Tensor] = None,
               cand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One optimizer step on the batch (inputs, targets, mask), by the
    full softmax or, given ``cand``, the sampled one.  → the loss before
    the step (detached, on the device: no host sync)."""
    if cand is not None:
        loss = sampled_softmax_loss(model, xi, xt, xm, log_q, cand)
    else:
        loss = full_softmax_loss(model, xi, xt, xm)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def frame_sentences(sentences, bos: int, eos: int):
    """(inputs, targets, mask) (N, T) with <s> before and </s> after."""
    T = max(len(s) for s in sentences) + 1
    N = len(sentences)
    inp = np.zeros((N, T), np.int64)
    tgt = np.zeros((N, T), np.int64)
    mask = np.zeros((N, T), bool)
    for i, s in enumerate(sentences):
        seq = [bos] + list(s)
        out = list(s) + [eos]
        inp[i, :len(seq)] = seq
        tgt[i, :len(out)] = out
        mask[i, :len(out)] = True
    return inp, tgt, mask


def train_rnnlm(sentences: Sequence[Sequence[int]], cfg: RnnLmConfig,
                num_epochs: int = 20, batch_size: int = 16,
                learning_rate: float = 5e-3, bos: int = 1, eos: int = 2,
                seed: int = 0, sample_k: Optional[int] = None,
                device: torch.device | str = "cuda",
                stats: Optional[dict] = None) -> RnnLm:
    """sentences: word-id sequences (without <s>/</s>; added here).
    sample_k: if set (and < vocab), train with importance-sampled
    softmax over sample_k shared Gumbel-top-k candidates per step
    instead of the full V-wide softmax.  Adam (torch.optim.Adam is
    optax.adam's update) on ``device``; batches in the original's order
    (``np.random.default_rng(seed)``), the trailing partial batch
    dropped.  Returns the trained model; ``stats`` gets ``steps``,
    ``nll`` (the last epoch's mean nll per word) and ``train_s``."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    model = init_rnnlm(RnnLm(cfg), seed).to(device)
    rng = np.random.default_rng(seed)
    N = len(sentences)
    inp, tgt, mask = (torch.from_numpy(a).to(device)
                      for a in frame_sentences(sentences, bos, eos))
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    use_sampling = sample_k is not None and sample_k < cfg.vocab_size
    log_q = torch.from_numpy(np.log(unigram_proposal(
        sentences, cfg.vocab_size, eos=eos))).to(device) \
        if use_sampling else None
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    B = min(batch_size, N)
    steps, nll = 0, float("nan")
    for epoch in range(num_epochs):
        order = torch.from_numpy(rng.permutation(N)).to(device)
        tot = torch.zeros((), dtype=torch.float64, device=device)
        nb = 0
        for i in range(0, N - B + 1, B):
            idx = order[i:i + B]
            cand = draw_candidates(log_q, sample_k, gen) \
                if use_sampling else None
            tot += train_step(model, opt, inp[idx], tgt[idx], mask[idx],
                              log_q, cand)
            nb += 1
        steps += nb
        if epoch % 5 == 0 or epoch == num_epochs - 1:
            nll = float(tot) / max(nb, 1)
            log.info("rnnlm epoch %d: nll/word %.3f (ppl %.1f)%s", epoch,
                     nll, float(np.exp(nll)),
                     " [sampled]" if use_sampling else "")
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.update(steps=steps, nll=nll,
                     train_s=time.perf_counter() - t0)
    return model


@torch.no_grad()
def perplexity(model: RnnLm, sentences: Sequence[Sequence[int]],
               bos: int = 1, eos: int = 2, batch: int = 256) -> float:
    """Exact (full-softmax) per-word perplexity of held-out sentences,
    on the model's device, ``batch`` sentences a forward."""
    dev = model.output.kernel.device
    tot, n = 0.0, 0
    for i in range(0, len(sentences), batch):
        inp, tgt, mask = (torch.from_numpy(a).to(dev)
                          for a in frame_sentences(sentences[i:i + batch],
                                                   bos, eos))
        lp = torch.log_softmax(model(inp)[0], dim=-1)
        got = torch.gather(lp, 2, tgt[..., None])[..., 0]
        tot -= float(torch.where(mask, got, 0.0).double().sum())
        n += int(mask.sum())
    return float(np.exp(tot / max(n, 1)))


class RnnLmScorer:
    """score(history_words, word) → log P, with RNN-state memoization
    (the KaldiRnnlmDeterministicFst role).  One GRU step per new history
    on ``device``: the carries stay there, and one row of log-probs a
    history comes back to the host.  ``steps`` counts the histories
    scored."""

    def __init__(self, model: RnnLm, words: SymbolTable,
                 bos: str = "<s>", eos: str = "</s>",
                 device: torch.device | str = "cuda"):
        dev = resolve_device(device)
        self.words = words
        self.bos = bos
        self.eos = eos
        self.device = dev
        self.steps = 0
        self._cache: Dict[Tuple[str, ...],
                          Tuple[np.ndarray, torch.Tensor]] = {}
        with torch.no_grad():
            w_i, b_i, w_h, b_h = (t.detach().to(dev)
                                  for t in model.gru.packed())
            # every word's input products, once
            self._xi = model.embed.embedding.detach().to(dev) @ w_i + b_i
            self._w_h, self._b_h = w_h, b_h
            self._w_out = model.output.kernel.detach().to(dev)
            self._b_out = model.output.bias.detach().to(dev)
        self._h0 = torch.zeros((1, model.config.hidden_dim), device=dev)

    @torch.no_grad()
    def _step(self, carry: torch.Tensor, tok: int):
        h = FlaxGru.cell(self._xi[tok][None], carry, self._w_h, self._b_h)
        lp = torch.log_softmax(torch.addmm(self._b_out, h, self._w_out),
                               dim=-1)
        self.steps += 1
        return lp[0].cpu().numpy(), h

    def _state_for(self, hist: Tuple[str, ...]):
        """(logprobs over next word, carry) after consuming hist."""
        if hist in self._cache:
            return self._cache[hist]
        if len(hist) == 0:
            raise ValueError("history must start with <s>")
        if len(hist) == 1:
            carry = self._h0
        else:
            _, carry = self._state_for(hist[:-1])
        out = self._step(carry, self.words.get(hist[-1], 0))
        self._cache[hist] = out
        return out

    def score(self, hist: Tuple[str, ...], word: str) -> float:
        """Natural-log P(word | hist); hist implicitly starts at <s>."""
        full_hist = hist if hist and hist[0] == self.bos \
            else (self.bos,) + tuple(hist)
        lp, _ = self._state_for(full_hist)
        wid = self.words.get(word, 0)
        return float(lp[wid])


def save_rnnlm(path: str, model: RnnLm) -> None:
    """Token-framed RNNLM model file (<RnnLm> dims + flax msgpack
    payload; the rnnlm final.raw role), as the original writes it."""
    cfg = model.config
    blob = msgpack.packb(params_to_flax(model))
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<RnnLm>")
        for tok, v in (("<VocabSize>", cfg.vocab_size),
                       ("<EmbedDim>", cfg.embed_dim),
                       ("<HiddenDim>", cfg.hidden_dim),
                       ("<NumBytes>", len(blob))):
            kio.write_token(f, tok)
            kio.write_basic_int32(f, v)
        f.write(blob)
        kio.write_token(f, "</RnnLm>")


def load_rnnlm(path: str, device: torch.device | str = "cuda") -> RnnLm:
    """The model in an <RnnLm> file (the port's or the original's), on
    ``device``."""
    device = resolve_device(device)
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not a binary kaldi file")
        kio.expect_token(f, "<RnnLm>")
        vals = []
        for tok in ("<VocabSize>", "<EmbedDim>", "<HiddenDim>",
                    "<NumBytes>"):
            kio.expect_token(f, tok)
            vals.append(kio.read_basic_int32(f))
        blob = f.read(vals[3])
        kio.expect_token(f, "</RnnLm>")
    cfg = RnnLmConfig(vocab_size=vals[0], embed_dim=vals[1],
                      hidden_dim=vals[2])
    model = RnnLm(cfg)
    model.load_state_dict(params_from_flax(msgpack.unpackb(blob)))
    return model.to(device)
