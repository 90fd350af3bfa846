"""Chain (LF-MMI) model training pipeline.

Port of kaldi_tpu/pipelines/chain.py (parity target:
steps/nnet3/chain/train.py + nnet3-chain-train): egs from phone
alignments (``make_chain_egs``, host numpy), and ``ChainTrainer``, which
runs egs → the model (a ``TdnnChain`` or an xconfig chain model,
am/xconfig.py) in training mode → ``chain_objf`` (the
denominator through the forward-backward kernel on the card) →
backward → NG-SGD or AdamW with max-change → updated model, with the
original's optax semantics: a continuous exponential learning-rate
decay read at step counts 0, 1, …, AdamW's weight decay 1e-4 inside the
update, and each tensor's final update clamped to l2 ≤ max_change before
it is applied.  Checkpoints are ``torch.save`` files (the original
writes orbax ones, which ``restore`` reads).

``build_chain_tree`` (the left-biphone tree from GMM alignments) is the
original's host numpy, on the port's tree statistics and questions
(pipelines/tri.py).

Egs may carry lattice-derived or end-to-end supervision FSAs
(``ChainEgs.sup``, am/chain_supervision.py): a step then moves its rows
of them to the device once and the numerator runs through the FSA at
``ChainTrainConfig.supervision_tolerance``.

``ChainTrainer(mesh=)`` (parallel/mesh.py) trains data-parallel across
the ranks of a process group with global-batch semantics: the sharded
step equals the unsharded step on the same batch.  Every rank draws the
same batch order and takes its contiguous rows; the loss is normalized
by the batch's frame count (all-reduced), the l2 term by its score
count, and the orthonormal penalty, a parameter term, is added on data
rank 0 only; batch norm takes its statistics over the whole batch
(am/tdnn.py ``set_batch_norm_group``); after ``backward`` one flat
all-reduce sums the ranks' gradients (with the loss and diagnostics), so
NG-SGD / AdamW and max-change see the same gradients on every rank and
the parameters stay equal to the bit.  Dropout cannot draw the unsharded
masks: each rank's generator is seeded ``seed + data rank``.

A model axis above 1 shards a ``TdnnChain`` (tensor parallelism;
parallel/mesh.py ``shard_params``, parallel/tensor.py): the ranks of
one data index take the same rows, each holds its slice of every
sharded matrix and computes the whole scores with the model's
collectives, so every model rank runs the den on the whole pdf set.
The gradients are summed over the data axis as above, then the
replicated biases that were added as a slice are summed over the model
axis; NG-SGD and AdamW take each sharded gradient whole and step as the
unsharded optimizer does (ops/natural_gradient.py).  Checkpoints hold
the whole tensors in the unsharded layout, so one written on any mesh
restores on any other.  ``restore`` also reads the JAX package's orbax
checkpoints (pipelines/checkpoint.py), with a fresh optimizer.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.am.chain import (ChainTrainingOptions,
                                      DenominatorGraph, chain_objf)
from kaldi_tpu_torch.am.chain_supervision import sup_to_device
from kaldi_tpu_torch.am.tdnn import (TdnnChain, TdnnConfig, init_like_flax,
                                     semi_orthogonal_penalty,
                                     set_batch_norm_group,
                                     set_dropout_generator)
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import GaussStats, build_tree
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.ops.natural_gradient import (NgSgd, Schedule,
                                                  ScheduledOptimizer)
from kaldi_tpu_torch.pipelines.tri import (_frame_info,
                                           cluster_phone_questions)

log = get_logger(__name__)


@dataclasses.dataclass
class ChainEgs:
    """Fixed-size training chunks (nnet3-chain-egs equivalent).

    entry_pdf/self_pdf/num_segs describe the chunk's phone-segment
    sequence for the flexible-boundary numerator; pdf_ali is the
    fixed-path fallback.  entry_w/self_w/init_w/final_w are the
    normalization-FST weights.  ``sup``, a ``pack_supervisions`` dict of
    padded FSA arrays (lattice-derived or end-to-end supervision,
    am/chain_supervision.py), overrides both numerators."""
    feats: np.ndarray       # (N, chunk_T, D)
    pdf_ali: np.ndarray     # (N, chunk_T // sub) int32
    mask: np.ndarray        # (N, chunk_T // sub) bool
    entry_pdf: np.ndarray = None   # (N, S_max) int32
    self_pdf: np.ndarray = None    # (N, S_max) int32
    num_segs: np.ndarray = None    # (N,) int32
    entry_w: np.ndarray = None     # (N, S_max) f32
    self_w: np.ndarray = None      # (N, S_max) f32
    init_w: np.ndarray = None      # (N,) f32
    final_w: np.ndarray = None     # (N,) f32
    sup: Dict[str, np.ndarray] = None


def make_chain_egs(feats: Dict[str, np.ndarray],
                   phone_alignments: Dict[str, List[Tuple[int, int]]],
                   tree, topo: HmmTopology,
                   chunk_size: int = 96, subsample: int = 3,
                   den=None) -> ChainEgs:
    """Cut utterances into fixed chunks; numerator pdfs from phone
    alignments ((phone, duration) runs) through the chain topology:
    first subsampled frame of a phone = forward pdf, rest = self pdf.
    With ``den`` (a DenominatorGraph with its PhoneLm), each chunk also
    carries normalization-FST weights computed with the true cross-chunk
    phone history.

    Port of the original with its (3,1)-tree fault repaired: the last
    segment of a chunk gets the phone that follows it in the utterance
    as right context (the original gives it 0 even when the utterance
    goes on), and the next-phone search is one backward pass, not O(T²).
    Monophone and (2,1) trees read no right context: their egs equal the
    original's."""
    X, A, M, EP, NW = [], [], [], [], []
    out_T = chunk_size // subsample

    def dedup_runs(seq):
        out = []
        for p in seq:
            if not out or out[-1] != p:
                out.append(p)
        return out

    def norm_weights(segs, context_phones):
        """(entry_w, self_w, init_w, final_w) along the segment chain,
        by LM state (norm_view), for monophone and biphone den graphs."""
        lm = den.lm
        nv_init, nv_self, nv_fwd, nv_final = den.norm_view()
        ew = np.zeros(out_T, np.float32)
        sw = np.zeros(out_T, np.float32)
        st = lm.state_of(context_phones)   # state of segment 0 (w/ history)
        init_w = den.initial_for(context_phones)
        sw[0] = nv_self[st]
        for i in range(1, len(segs)):
            c = lm.phones.index(segs[i])
            ew[i] = nv_fwd[st] + lm.next_logp[st, c]
            st = int(lm.next_state[st, c])
            sw[i] = nv_self[st]
        return ew, sw, np.float32(init_w), np.float32(nv_final[st])

    for u, f in sorted(feats.items()):
        # full-rate phone sequence, then subsample PHONES (midpoint rule)
        # and re-derive pdfs so every phone entry emits its forward pdf
        phones_full: List[int] = []
        for phone, dur in phone_alignments[u]:
            phones_full.extend([phone] * dur)
        T = min(len(phones_full), f.shape[0])
        T_sub_total = T // subsample
        sub_phones = [phones_full[min(subsample * t + subsample // 2, T - 1)]
                      for t in range(T_sub_total)]
        # nxt[t]: the next phone after sub-frame t's instance (0 at the
        # utterance end), in one backward pass
        nxt = [0] * T_sub_total
        for t in range(T_sub_total - 2, -1, -1):
            nxt[t] = (sub_phones[t + 1] if sub_phones[t + 1] != sub_phones[t]
                      else nxt[t + 1])

        def pdfs_for(phone, is_entry, left=0, right=0):
            """pdf of a phone instance through the tree, with the true
            phone context for (2,1) and (3,1) trees."""
            cw, cp = tree.context_width, tree.central_position
            if cw == 1:
                window = [phone]
            elif (cw, cp) == (2, 1):
                window = [left, phone]
            elif (cw, cp) == (3, 1):
                window = [left, phone, right]
            else:
                raise KaldiError(
                    f"make_chain_egs: unsupported tree context "
                    f"({cw},{cp})")
            st = topo.topology_for_phone(phone)[0]
            cls = (st.forward_pdf_class if is_entry
                   else st.self_loop_pdf_class)
            return tree.compute(window, cls)

        sub_pdfs_full = []
        prev_ph = 0
        for t, ph in enumerate(sub_phones):
            entry = t == 0 or sub_phones[t - 1] != ph
            if t > 0 and entry:
                prev_ph = sub_phones[t - 1]
            sub_pdfs_full.append(pdfs_for(ph, entry, prev_ph, nxt[t]))

        def segs_of(chunk_sub_phones):
            segs = []
            for t, ph in enumerate(chunk_sub_phones):
                if t == 0 or chunk_sub_phones[t - 1] != ph:
                    segs.append(ph)
            return segs

        def seg_arrays(chunk_sub_phones, left_ctx, right_ctx):
            """left_ctx / right_ctx: the phone instances before the
            chunk's first segment and after its last (0 at the
            utterance's ends)."""
            segs = segs_of(chunk_sub_phones)
            e = np.zeros(out_T, np.int32)
            sl = np.zeros(out_T, np.int32)
            for i, ph in enumerate(segs):
                left = segs[i - 1] if i > 0 else left_ctx
                right = segs[i + 1] if i + 1 < len(segs) else right_ctx
                e[i] = pdfs_for(ph, True, left, right)
                sl[i] = pdfs_for(ph, False, left, right)
            return e, sl, np.int32(len(segs))

        def left_ctx_of(start_sub):
            """Phone of the instance preceding the chunk's first
            segment's instance (0 at utterance start)."""
            first = sub_phones[start_sub] if start_sub < len(sub_phones) \
                else 0
            for t in range(start_sub - 1, -1, -1):
                if sub_phones[t] != first:
                    return sub_phones[t]
            return 0

        for start_sub in range(0, T_sub_total - out_T + 1, out_T):
            start = start_sub * subsample
            X.append(f[start:start + chunk_size])
            A.append(np.asarray(
                sub_pdfs_full[start_sub:start_sub + out_T], np.int32))
            M.append(np.ones(out_T, bool))
            chunk_phones = sub_phones[start_sub:start_sub + out_T]
            EP.append(seg_arrays(chunk_phones, left_ctx_of(start_sub),
                                 nxt[start_sub + out_T - 1]))
            if den is not None and den.lm is not None:
                NW.append(norm_weights(
                    segs_of(chunk_phones),
                    dedup_runs(sub_phones[:start_sub + 1])))
        rem_sub = T_sub_total % out_T
        if rem_sub >= 4:
            start_sub = T_sub_total - rem_sub
            start = start_sub * subsample
            chunk_f = np.zeros((chunk_size, f.shape[1]), f.dtype)
            chunk_f[:T - start] = f[start:T]
            sub_pdfs = np.zeros(out_T, np.int32)
            sp = sub_pdfs_full[start_sub:]
            sub_pdfs[:len(sp)] = sp
            m = np.zeros(out_T, bool)
            m[:len(sp)] = True
            X.append(chunk_f)
            A.append(sub_pdfs)
            M.append(m)
            EP.append(seg_arrays(sub_phones[start_sub:],
                                 left_ctx_of(start_sub), 0))
            if den is not None and den.lm is not None:
                NW.append(norm_weights(
                    segs_of(sub_phones[start_sub:]),
                    dedup_runs(sub_phones[:start_sub + 1])))
    kw = {}
    if NW:
        kw = dict(entry_w=np.stack([w[0] for w in NW]),
                  self_w=np.stack([w[1] for w in NW]),
                  init_w=np.asarray([w[2] for w in NW], np.float32),
                  final_w=np.asarray([w[3] for w in NW], np.float32))
    return ChainEgs(np.stack(X).astype(np.float32), np.stack(A),
                    np.stack(M),
                    entry_pdf=np.stack([e for e, _, _ in EP]),
                    self_pdf=np.stack([s_ for _, s_, _ in EP]),
                    num_segs=np.asarray([n for _, _, n in EP], np.int32),
                    **kw)


@dataclasses.dataclass
class ChainTrainConfig:
    num_epochs: int = 10
    batch_size: int = 16
    learning_rate: float = 1e-3
    final_learning_rate: float = 1e-4
    # Kaldi's per-component max-change: each parameter tensor's update
    # l2-norm is clamped to this value; 0 disables
    max_change: float = 2.0
    # exponential lr decay initial→final over this many steps; None =
    # derived from num_epochs × batches at train() time, 0 = constant lr
    total_steps: Optional[int] = None
    orthonormal_weight: float = 1e-2
    # flexible-boundary supervision numerator; falls back to the fixed
    # alignment path when egs lack segment arrays
    use_flexible_numerator: bool = True
    # boundary tolerance (subsampled frames) of supervision FSAs
    # (egs.sup, chain-supervision's ±tolerance); >= the longest
    # utterance = free boundaries (end-to-end egs)
    supervision_tolerance: int = 1
    # "ngsgd" = natural-gradient SGD with momentum (ops/natural_gradient.py);
    # "adamw" = optax.adamw's update
    optimizer: str = "adamw"
    momentum: float = 0.9
    opts: ChainTrainingOptions = dataclasses.field(
        default_factory=ChainTrainingOptions)


class AdamW(ScheduledOptimizer):
    """optax.adamw (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    every tensor, decoupled) followed by the max-change clamp of the
    final update: u = −lr·(m̂/(√v̂ + eps) + wd·p), clamped, then added.
    ``lr`` is a float or a schedule of the step count (0 first).  It
    works entry by entry, so a shard on a model axis keeps its slice of
    the moments and steps its slice; only the clamp's norm is summed
    over the axis (ScheduledOptimizer.apply)."""

    def __init__(self, params, lr: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_change: float = 0.0):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay), lr,
                         max_change)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr = self.lr()
        k = self.count + 1
        updates = []
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if "mu" not in st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                g = p.grad
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                mu_hat = st["mu"] / (1 - b1 ** k)
                nu_hat = st["nu"] / (1 - b2 ** k)
                u = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                u = u + group["weight_decay"] * p
                updates.append((p, -lr * u))
        self.apply(updates)
        self.count += 1
        return loss


def exponential_decay(init: float, total_steps: int, rate: float):
    """optax.exponential_decay(init, transition_steps=total_steps,
    decay_rate=rate): continuous, init·rate^(count/total_steps)."""
    return lambda count: init * rate ** (count / total_steps)


class ChainTrainer:
    """Owns the model, the denominator graph and the optimizer; ``_step``
    is one training step on a batch."""

    def __init__(self, model_cfg, den: DenominatorGraph,
                 cfg: ChainTrainConfig = None, seed: int = 0,
                 device: torch.device | str = "cuda", mesh=None):
        """``model_cfg`` is a TdnnConfig (the trainer builds a TdnnChain)
        or a model with the chain contract: forward (B, T, feat_dim) →
        (B, T // sub, num_pdfs) scores, and a ``feat_dim`` (an xconfig
        chain model, am/xconfig.py ``chain_model_from_xconfig``).  Either
        gets fresh weights from flax's distributions (``init_like_flax``,
        seeded by ``seed``); dropout masks come from the trainer's
        ``generator``, seeded by ``seed`` on ``device``.  With ``mesh``
        (parallel/mesh.py ``make_mesh``; every rank constructs the
        trainer) it trains data-parallel on the mesh's device, whatever
        ``device`` says, rank 0's weights broadcast to every rank (module
        docstring); on a model axis above 1 each rank keeps its slice of
        the whole model."""
        from kaldi_tpu_torch.parallel.mesh import replicate, shard_params
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.cfg = cfg or ChainTrainConfig()
        model = (TdnnChain(model_cfg) if isinstance(model_cfg, TdnnConfig)
                 else model_cfg)
        self.model = init_like_flax(model, seed)
        rank = 0
        if mesh is not None:
            self.model = shard_params(
                replicate(self.model.to(mesh.device), mesh), mesh)
            rank = mesh.data_index
            if mesh.data > 1:
                set_batch_norm_group(self.model, mesh.data_group, mesh.data)
        self.model = self.model.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + rank)
        set_dropout_generator(self.model, self.generator)
        self.den = den
        self._trained_steps = 0
        self._build_tx(self.cfg.total_steps or 0)

    def _build_tx(self, total_steps: int) -> None:
        """NG-SGD or AdamW, the exponential lr decay and the per-tensor
        max-change (the nnet3-train stabilizers); fresh optimizer
        state."""
        cfg = self.cfg
        if total_steps and cfg.final_learning_rate < cfg.learning_rate:
            lr = exponential_decay(cfg.learning_rate, max(total_steps, 1),
                                   cfg.final_learning_rate
                                   / cfg.learning_rate)
        else:
            lr = cfg.learning_rate
        params = self.model.parameters()
        if cfg.optimizer == "ngsgd":
            self.opt = NgSgd(params, lr, momentum=cfg.momentum,
                             max_change=cfg.max_change)
        elif cfg.optimizer == "adamw":
            self.opt = AdamW(params, lr, max_change=cfg.max_change)
        else:
            raise KaldiError(f"unknown optimizer {cfg.optimizer!r}")
        if self._model_axis:
            named = dict(self.model.named_parameters())
            self.opt.shard({named[k]: sh for k, sh in
                            self.model.tp_shards.items()}, self.mesh)

    @property
    def _model_axis(self) -> bool:
        return self.mesh is not None and self.mesh.model > 1

    def _as_tensor(self, a, dtype=None):
        if a is None:
            return None
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=self.device, dtype=dtype)

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.data > 1

    def _loss_fn(self, feats, pdf_ali, mask, num_graph, sup=None):
        scores = self.model(feats)
        num_fsa = ((sup, self.cfg.supervision_tolerance)
                   if sup is not None else None)
        norm = None
        if self._sharded:
            frames = self.mesh.all_reduce_data(mask.sum().to(scores.dtype))
            norm = (frames, scores.numel() * self.mesh.data)
        loss, diag = chain_objf(self.den, scores, pdf_ali, mask,
                                self.cfg.opts, num_graph=num_graph,
                                num_fsa=num_fsa, norm=norm)
        if not self._sharded or self.mesh.data_index == 0:
            loss = loss + self.cfg.orthonormal_weight * \
                semi_orthogonal_penalty(self.model)
        return loss, diag

    @staticmethod
    def _sum_in_place(tensors, all_reduce) -> None:
        """``all_reduce`` (a mesh axis' sum) of ``tensors`` as one flat
        buffer, the sums written back."""
        flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    def _all_reduce_grads(self, loss, diag):
        """One flat all-reduce over the data axis of every gradient, the
        loss and the diagnostics (each rank's share of the batch's) →
        the batch's (loss, diagnostics); the summed gradients are written
        back."""
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        keys = sorted(diag)
        stats = torch.stack([loss.detach()] + [diag[k].detach()
                                               for k in keys]).to(
            grads[0].dtype)
        self._sum_in_place(grads + [stats], self.mesh.all_reduce_data)
        return stats[0], {k: stats[1 + i] for i, k in enumerate(keys)}

    def _sum_partial_grads(self) -> None:
        """One flat all-reduce over the model axis of the gradients of the
        replicated biases each rank added as its slice (zero outside it),
        so that every rank steps them by the whole gradient."""
        named = dict(self.model.named_parameters())
        grads = [named[k].grad for k in self.model.tp_partial
                 if named[k].grad is not None]
        if grads:
            self._sum_in_place(grads, self.mesh.all_reduce_model)

    def _step(self, feats, pdf_ali, mask, num_graph=None, sup=None):
        """One step on a batch (arrays or tensors; ``sup`` a batch's rows
        of a ``pack_supervisions`` dict, numpy or already on the device):
        forward in training mode (the batch-norm statistics move), loss,
        backward, optimizer update.  → (loss, diagnostics), detached
        tensors on the device."""
        self.model.train()
        feats = self._as_tensor(feats, torch.float32)
        pdf_ali = self._as_tensor(pdf_ali, torch.int64)
        mask = self._as_tensor(mask, torch.bool)
        if num_graph is not None:
            num_graph = tuple(self._as_tensor(a) for a in num_graph)
        if sup is not None and not isinstance(sup["src"], torch.Tensor):
            sup = sup_to_device(sup, self.device)
        loss, diag = self._loss_fn(feats, pdf_ali, mask, num_graph, sup)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        if self._sharded:
            loss, diag = self._all_reduce_grads(loss, diag)
        if self._model_axis:
            self._sum_partial_grads()
        self.opt.step()
        return loss.detach(), {k: v.detach() for k, v in diag.items()}

    # -- checkpoint / resume (steps/nnet3 N.mdl + --stage contract) --------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict in the unsharded layout (whole tensors;
        on a model axis every rank of it must call)."""
        if not self._model_axis:
            return self.model.state_dict()
        from kaldi_tpu_torch.parallel.tensor import full_state_dict
        return full_state_dict(self.model, self.mesh)

    def load_state_dict(self, state_dict) -> None:
        """Load an unsharded state dict (this rank's slices of it on a
        model axis)."""
        if not self._model_axis:
            self.model.load_state_dict(state_dict)
            return
        from kaldi_tpu_torch.parallel.tensor import load_full_state_dict
        load_full_state_dict(self.model, state_dict, self.mesh)

    def save(self, ckpt_dir: str, step: int) -> None:
        """``ckpt_{step}.pt``: the step, the whole tensors and the
        optimizer state (a shard's gathered whole), written by rank 0
        (every rank must call)."""
        state = {"step": step, "model": self.state_dict(),
                 "opt": self.opt.state_dict()}
        if self.mesh is None or self.mesh.rank == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            torch.save(state, os.path.join(ckpt_dir, f"ckpt_{step}.pt"))
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist
            dist.barrier()

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Load the checkpoint of ``step`` (None: the latest) → its step.
        A directory of the JAX package's orbax checkpoints (``step_N``)
        loads its params and batch statistics (pipelines/checkpoint.py)
        and restarts the optimizer."""
        from kaldi_tpu_torch.pipelines import checkpoint
        steps = [int(os.path.basename(p)[5:-3]) for p in
                 glob.glob(os.path.join(ckpt_dir, "ckpt_*.pt"))]
        if not steps and checkpoint.latest_step(ckpt_dir) is not None:
            return self._restore_orbax(ckpt_dir, step)
        if step is None:
            if not steps:
                raise KaldiError(f"no checkpoint in {ckpt_dir}")
            step = max(steps)
        state = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                           map_location=self.device, weights_only=True)
        self.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        self._trained_steps = int(state["step"])
        return self._trained_steps

    def _restore_orbax(self, ckpt_dir: str, step: Optional[int]) -> int:
        from kaldi_tpu_torch.am.tdnn import (params_from_flax,
                                             state_dict_from_flax)
        from kaldi_tpu_torch.pipelines.checkpoint import read_train_state
        state = read_train_state(ckpt_dir, step)
        tree = {"params": state["params"],
                "batch_stats": state["batch_stats"]}
        sd = (params_from_flax(tree) if isinstance(self.model, TdnnChain)
              else state_dict_from_flax(tree))
        self.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self._build_tx(self.cfg.total_steps or 0)
        self._trained_steps = int(state["step"])
        return self._trained_steps

    def batches(self, egs: ChainEgs, idx: np.ndarray):
        """The ``_step`` arguments of the egs at ``idx``: supervision FSAs
        when the egs carry them, else the flexible numerator's segments
        when on and present, else the fixed alignment alone.  With a
        mesh, this rank's contiguous rows of ``idx`` (every rank passes
        the same ``idx``, whose length must divide over the data axis)."""
        if self._sharded:
            from kaldi_tpu_torch.parallel.mesh import batch_sharding
            idx = np.asarray(idx)[batch_sharding(self.mesh, len(idx))]
        num_graph = sup = None
        if egs.sup is not None:
            sup = {k: v[idx] for k, v in egs.sup.items()}
        elif self.cfg.use_flexible_numerator and egs.entry_pdf is not None:
            num_graph = (egs.entry_pdf[idx], egs.self_pdf[idx],
                         egs.num_segs[idx])
            if egs.entry_w is not None:
                num_graph = num_graph + (egs.entry_w[idx], egs.self_w[idx],
                                         egs.init_w[idx], egs.final_w[idx])
        return (egs.feats[idx], egs.pdf_ali[idx], egs.mask[idx], num_graph,
                sup)

    def train(self, egs: ChainEgs, log_every: int = 20,
              ckpt_dir: Optional[str] = None) -> Dict[str, float]:
        N = egs.feats.shape[0]
        B = min(self.cfg.batch_size, N)
        if self.cfg.total_steps is None and self._trained_steps == 0:
            # derive the lr-decay horizon now that the eg count is known
            self._build_tx(self.cfg.num_epochs * max(N // B, 1))
        rng = np.random.default_rng(0)
        step = 0
        last: Dict[str, float] = {}
        for epoch in range(self.cfg.num_epochs):
            order = rng.permutation(N)
            for i in range(0, N - B + 1, B):
                loss, diag = self._step(*self.batches(egs, order[i:i + B]))
                step += 1
                self._trained_steps += 1
                if step % log_every == 0:
                    log.info("chain step %d: loss %.4f objf %.4f "
                             "(num %.3f den %.3f)", step, float(loss),
                             float(diag["objf"]), float(diag["num"]),
                             float(diag["den"]))
            last = {"loss": float(loss), "objf": float(diag["objf"])}
            if ckpt_dir is not None:
                self.save(ckpt_dir, step)
        return last

    # -- inference ---------------------------------------------------------
    def scores_fn(self):
        """(B, T, D) → (B, T/sub, P) scorer in eval mode."""
        def f(feats):
            self.model.eval()
            with torch.no_grad():
                return self.model(self._as_tensor(feats, torch.float32))
        return f


def _adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.adam as a closure over its state: g → the update to add."""
    state = {"count": 0, "mu": 0.0, "nu": 0.0}

    def update(g):
        state["count"] += 1
        k = state["count"]
        state["mu"] = (1 - b1) * g + b1 * state["mu"]
        state["nu"] = (1 - b2) * g * g + b2 * state["nu"]
        mu_hat = state["mu"] / (1 - b1 ** k)
        nu_hat = state["nu"] / (1 - b2 ** k)
        return -lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    return update


def combine_models(nets: Sequence[torch.nn.Module], den: DenominatorGraph,
                   egs: ChainEgs, num_iters: int = 30, lr: float = 0.2,
                   opts: Optional[ChainTrainingOptions] = None,
                   trace: Optional[list] = None,
                   replay: Optional[Sequence[np.ndarray]] = None):
    """nnet3-chain-combine's optimization (the original tool's, as a
    function; chainbin/nnet3-chain-combine.cc): every parameter of the
    combined model is Σ_i softmax(w)_i · model_i's, the batch-norm
    statistics are the first model's, and ``num_iters`` steps of Adam
    (optax's, at ``lr``) from w = 0 minimise the LF-MMI loss of the
    models in eval mode on all of ``egs`` as one batch (fixed-alignment
    numerator; the den on the models' device).  ``nets``: TdnnChains of
    one shape on one device.  ``trace``, a list, gets each step's
    (loss, gradient on the logits) as a float and a numpy array;
    ``replay``, another run's gradients, one a step, steps Adam by them
    instead of its own, so that ``trace`` holds this run's loss and
    gradient at that run's points.  → (the combined state dict, the
    weights, the last objective)."""
    net = nets[0]
    device = next(net.parameters()).device
    names = [k for k, _ in net.named_parameters()]
    stack = {k: torch.stack([m.state_dict()[k] for m in nets])
             for k in names}
    buffers = {k: v for k, v in net.named_buffers()}
    feats = torch.as_tensor(egs.feats, dtype=torch.float32).to(device)
    pdf_ali = torch.as_tensor(egs.pdf_ali, dtype=torch.int64).to(device)
    mask = torch.as_tensor(egs.mask).to(device)
    opts = opts or ChainTrainingOptions()

    def mix(logits):
        wgt = torch.softmax(logits, dim=0)
        return {k: torch.tensordot(wgt, s, dims=1) for k, s in stack.items()}

    logits = torch.zeros(len(nets), device=device)
    adam = _adam(lr)
    loss = None
    for it in range(num_iters):
        lg = logits.clone().requires_grad_(True)
        scores = torch.func.functional_call(net, {**mix(lg), **buffers},
                                            (feats,))
        loss = chain_objf(den, scores, pdf_ali, mask, opts)[0]
        (g,) = torch.autograd.grad(loss, lg)
        if trace is not None:
            trace.append((float(loss.detach()), g.detach().cpu().numpy()))
        if replay is not None:
            g = torch.as_tensor(replay[it], dtype=g.dtype, device=device)
        logits = logits + adam(g)
    with torch.no_grad():
        mixed = mix(logits)
    return ({**mixed, **buffers}, torch.softmax(logits, 0).cpu().numpy(),
            -float(loss.detach()))


# Copied from kaldi_tpu/pipelines/chain.py build_chain_tree.
def build_chain_tree(feats: Dict[str, np.ndarray],
                     alignments: Dict[str, Sequence[int]],
                     tm: TransitionModel, topo: HmmTopology,
                     num_leaves: int,
                     context_width: int = 2, central_position: int = 1):
    """Context-dependent decision tree over the CHAIN topology from GMM
    alignments — steps/nnet3/chain/build_tree.sh.  The (2,1)
    left-biphone default is the reference's standard chain-tree
    configuration; it keeps the denominator graph near phone-LM size
    (am/chain.py _make_den_graph_biphone).

    Stats: per aligned frame, window = phone context of the instance,
    pdf-class = the chain topology's forward class on the instance's
    first frame and its self-loop class after (the 3-state GMM
    alignment collapses onto the 2-class chain topology by frame
    position, as build_tree.sh re-accumulates stats under the new
    topology)."""
    stats: Dict[Tuple[Tuple[int, ...], int], GaussStats] = {}
    for u, tids in alignments.items():
        f = np.asarray(feats[u], np.float64)
        info = _frame_info(tm, tids)
        phones: List[int] = []
        for pi, ph, st in info:
            if pi == len(phones):
                phones.append(ph)
        prev_pi = -1
        for t, (pi, ph, hmm_state) in enumerate(info):
            if t >= f.shape[0]:
                break
            window = []
            for off in range(-central_position,
                             context_width - central_position):
                j = pi + off
                window.append(phones[j] if 0 <= j < len(phones) else 0)
            entry = topo.topology_for_phone(ph)[0]
            pc = (entry.forward_pdf_class if pi != prev_pi
                  else entry.self_loop_pdf_class)
            prev_pi = pi
            key = (tuple(window), pc)
            if key not in stats:
                stats[key] = GaussStats(f.shape[1])
            stats[key].accumulate(f[t])
    questions = cluster_phone_questions(stats, central_position)
    tree = build_tree(stats, questions, context_width, central_position,
                      max_leaves=num_leaves)
    log.info("build_chain_tree: %d leaves over %d (window, class) "
             "events (context %d,%d)", tree.num_pdfs, len(stats),
             context_width, central_position)
    return tree


def phone_alignment_runs(tm: TransitionModel, tids: Sequence[int]
                         ) -> List[Tuple[int, int]]:
    """tid alignment → [(phone, duration in frames)] runs
    (ali-to-phones --write-lengths equivalent)."""
    runs: List[Tuple[int, int]] = []
    for tid in tids:
        phone = tm.transition_id_to_phone(tid)
        is_initial = (tm.transition_id_to_hmm_state(tid) == 0
                      and not tm.is_self_loop(tid))
        if is_initial or not runs:
            runs.append((phone, 1))
        else:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
    return runs
