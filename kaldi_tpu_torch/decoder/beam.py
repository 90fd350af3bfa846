"""Batched token-passing Viterbi beam decoder with exact lattice
generation, in PyTorch.

Port of kaldi_tpu/decoder/beam.py (parity target
src/decoder/lattice-faster-decoder.h and the fork's GPU decoder,
arXiv:1804.03243).  The graph packing, the frame step and the host
lattice assembly follow the original step for step, so that the same
graph and log-likelihoods give the same tokens, lattice records and
CompactLattices:

  * the graph is one packed int32 block table (each state's out-arcs
    padded to a multiple of ``arc_block``; padding arcs carry +inf
    weight), uploaded once to the decoder's device;
  * one frame = arc-budget cutoff (cost histogram) → load-balanced
    block expansion (searchsorted over the tokens' block cumsum) →
    acoustic + graph cost → beam prune → recombination by a stable
    sort on (state, cost) → max-active histogram cutoff → compaction
    → lattice records within ``lattice_beam``;
  * the batch dimension is written out: tokens are (B, K), candidates
    (B, M), and every sort runs along dim 1.  ``lax.scan`` becomes a
    Python loop over frames that issues only device work (no host
    sync: no ``.item()``, ``nonzero`` or boolean-mask indexing);
  * the multi-key sort on (state, cost) is one stable sort of an int64
    key ``state << 32 | order-preserving cost bits``, payloads moved by
    the returned indices;
  * the original's cursor appends become per-frame writes into a
    (B, T_pad, L, w) buffer, compacted once after the loop with
    cumsum + searchsorted + one gather into the same packed layout the
    host reads;
  * the device β-prune (``device_beta_prune``) is a reverse Python
    loop over the stored chunks; its dense β is a ``scatter_reduce``
    min instead of the TPU's sort-based construction.

The host side (records → raw lattice → determinized CompactLattice,
escalation policy) is copied from the original and calls
the port's copies of ``kaldi_tpu.native`` and
``kaldi_tpu.lattice.determinize`` (``kaldi_tpu_torch.native``,
``kaldi_tpu_torch.lattice.determinize``) exactly as it does.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.fst.csr import CsrGraph
from kaldi_tpu_torch.lattice.lattice import Lattice, LatticeArc

log = get_logger(__name__)

INF = float("inf")


@dataclasses.dataclass
class BeamDecoderConfig:
    """Mirrors LatticeFasterDecoderConfig option names (field meanings
    as in kaldi_tpu.decoder.beam.BeamDecoderConfig)."""
    beam: float = 16.0
    max_active: int = 7000         # max-active (histogram cutoff)
    acoustic_scale: float = 0.1
    lattice_beam: float = 8.0      # extra-cost beam for lattice arcs
    arc_budget: int = 0            # M: arcs expanded per frame (0 = auto)
    lattice_arcs_per_frame: int = 0   # L: records per frame; 0 = no lattice
    arc_block: int = 8             # arcs per row of the packed arc table
    token_capacity: int = 0        # K: token array size (0 = max_active)
    record_capacity: int = 0       # per-utterance record cap (0 = T_pad·L)
    escalate_budget: int = 0       # > arc_budget: re-decode at this budget
    #                                when the beam-deficit trigger fires
    device_beta_prune: bool = True  # reverse β pass on the device; only
    #                                records on paths within lattice_beam
    #                                of the best reach the host
    beta_prune_margin: float = 0.1  # f32-vs-f64 margin on the β keep bound
    escalate_deficit: float = 4.0  # Σ_t max(0, lattice_beam − eff_beam_t)
    #                                above which an utterance escalates


def _sortable_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 → int64 in [0, 2³²) with the same order (−0.0 counts as
    +0.0, as in JAX's sort)."""
    b = torch.where(x == 0, 0.0, x).view(torch.int32).to(torch.int64)
    return torch.where(b < 0, (~b) & 0xFFFFFFFF, b | 0x80000000)


def _f32(x: float) -> float:
    """A Python float rounded to float32, so a tensor op with it as a
    scalar computes what JAX's weak-typed f32 constant computes."""
    return float(np.float32(x))


def host_lattice_backend() -> str:
    """Which library the host lattice build and determinize run on:
    "native C++" when ``kaldi_tpu_torch.native`` built and loaded, else
    "numpy"."""
    from kaldi_tpu_torch import native
    return "native C++" if native.get_lib() is not None else "numpy"


class BeamDecoder:
    """Decoder bound to one graph; the packed arc table lives on
    ``device`` once and every decode reuses it."""

    _NBA = 64    # arc-budget cost histogram bins
    _NB = 64     # max-active cost histogram bins

    def __init__(self, graph: CsrGraph, tid_to_pdf: np.ndarray,
                 config: BeamDecoderConfig = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        if graph.num_eps_arcs:
            from kaldi_tpu_torch.fst.biglang import eps_precompose
            graph = eps_precompose(graph)
        self.graph = graph
        self.config = config or BeamDecoderConfig()
        cap = self.config.token_capacity or self.config.max_active
        self.K = max(1, min(cap, graph.num_states))
        self.maxa = min(self.config.max_active, self.K)
        blk = max(1, self.config.arc_block)
        self.BLK = blk
        self.L = self.config.lattice_arcs_per_frame
        if self.L and self.L < self.K:
            raise KaldiError("lattice_arcs_per_frame must be >= max_active "
                             "(every Viterbi arc must fit)")
        self.num_pdfs = int(tid_to_pdf.max()) + 1

        # block-aligned packed arc table (see the original's __init__):
        # arc fields [ns, w_bits, il, pdf, ol], BLK arcs per row
        A = graph.num_emitting_arcs
        S = graph.num_states
        cnt = (graph.e_offsets[1:] - graph.e_offsets[:-1]).astype(np.int64)
        cnt_blk = -(-cnt // blk)
        blk_off = np.zeros(S + 1, np.int64)
        np.cumsum(cnt_blk, out=blk_off[1:])
        A_blk = int(blk_off[-1])
        self._A_blk = A_blk
        self._set_budget()
        self._tok_bits = max(1, (self.K - 1).bit_length())
        flat = np.zeros((max(A_blk, 1) * blk, 5), np.int32)
        flat[:, 1] = np.float32(np.inf).view(np.int32)
        if A:
            src = np.repeat(np.arange(S), cnt)
            pos = (blk_off[src] * blk
                   + (np.arange(A) - graph.e_offsets[src])).astype(np.int64)
            flat[pos, 0] = graph.e_nextstate
            flat[pos, 1] = graph.e_weight.view(np.int32)
            flat[pos, 2] = graph.e_ilabel
            flat[pos, 3] = np.asarray(tid_to_pdf, np.int32)[graph.e_ilabel]
            flat[pos, 4] = graph.e_olabel
        tab = flat.reshape(max(A_blk, 1), blk * 5)
        state_blk = np.stack([blk_off[:S].astype(np.int32),
                              cnt_blk.astype(np.int32)], axis=1)
        self._flat = flat
        self._pack_pd = 2 * max(1, (self.K - 1).bit_length()) <= 31
        self._recw = 2 if self._pack_pd else 3
        self._check_capacity(self.config)

        init_states, init_costs = graph.initial_tokens()
        K = self.K
        ts = np.full(K, -1, np.int32)
        tc = np.full(K, np.float32(np.inf), np.float32)
        to = np.zeros(K, np.int32)
        tn = np.zeros(K, np.int32)
        n0 = min(len(init_states), K)
        ts[:n0] = init_states[:n0]
        tc[:n0] = init_costs[:n0]
        to[:n0] = blk_off[init_states[:n0]].astype(np.int32)
        tn[:n0] = cnt_blk[init_states[:n0]].astype(np.int32)
        # host-only olabel-sequence table + per-initial-slot olabels
        self._ol_seqs = list(graph.olabel_seqs or [])
        io = np.zeros(K, np.int64)
        if graph.init_olabels is not None:
            io[:n0] = np.asarray(graph.init_olabels[:n0], np.int64)
        self._init_ols = io

        self._g_host = {
            "arc_tab": tab,
            "state_blk": state_blk,
            "final": np.asarray(graph.final_costs, np.float32),
            "init_state": ts, "init_cost": tc,
            "init_off": to, "init_cnt": tn,
        }
        self._g = {k: torch.from_numpy(v).to(self.device)
                   for k, v in self._g_host.items()}
        # the Viterbi row of an identity (inactive) frame: each slot is
        # its own predecessor
        self._idn = torch.arange(K, dtype=torch.int64, device=self.device)
        self._esc = None

    def _set_budget(self):
        """M (arc rows expanded per frame) from the config: capped at
        the table's block count, floored at one block per token."""
        M = self.config.arc_budget or max(4 * self.K, 8192)
        self.MB = min(max(self._A_blk, 1), -(-M // self.BLK))
        self.MB = max(self.MB, -(-self.K // self.BLK))
        self.M = self.MB * self.BLK

    def _check_capacity(self, c: BeamDecoderConfig):
        if c.record_capacity and self.L and c.record_capacity < self.L:
            raise KaldiError("record_capacity must be >= "
                             "lattice_arcs_per_frame")

    # config fields that leave the packed graph tables and K untouched
    _SHARED_SAFE = ("beam", "max_active", "acoustic_scale",
                    "lattice_beam", "arc_budget",
                    "lattice_arcs_per_frame", "record_capacity",
                    "escalate_budget", "escalate_deficit",
                    "device_beta_prune", "beta_prune_margin")

    def with_overrides(self, **overrides) -> "BeamDecoder":
        """A sibling decoder sharing this one's packed graph (host and
        device copies) with different budget/beam knobs."""
        bad = set(overrides) - set(self._SHARED_SAFE)
        if bad:
            raise KaldiError(f"with_overrides: {sorted(bad)} change the "
                             "graph packing; construct a new BeamDecoder")
        clone = copy.copy(self)
        clone.config = dataclasses.replace(self.config, **overrides)
        clone.maxa = min(clone.config.max_active, clone.K)
        clone._set_budget()
        clone.L = clone.config.lattice_arcs_per_frame
        if clone.L and clone.L < clone.K:
            raise KaldiError("lattice_arcs_per_frame must be >= "
                             "max_active (every Viterbi arc must fit)")
        clone._check_capacity(clone.config)
        clone._esc = None            # never inherit an escalator sibling
        return clone

    # ------------------------------------------------------------------
    # device side
    # ------------------------------------------------------------------

    def _memory_bytes(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")

    def _use_beta(self, B: int, T_pad: int) -> bool:
        """β-prune on the device for this shape?  Needs lattices on, the
        config switch, and the chunk/α/output buffers to fit in a
        quarter of the device's memory."""
        if not (self.L and self.config.device_beta_prune):
            return False
        bytes_needed = B * T_pad * 4 * (
            self.L * (2 * self._recw + 1) + self.K)
        return bytes_needed <= self._memory_bytes() // 4

    def _sweep(self, tok, loglike, with_cost=False):
        """One frame for a batch: tok = (state, cost, off, cnt), each
        (B, K); loglike (B, P).  Returns (new_tok, (prev, aidx),
        chunk (B, L, w) | None, dropped (B,), (arcs_demand, n_heads,
        eff_beam))."""
        g = self._g
        c = self.config
        K, M, MB, blk, L = self.K, self.M, self.MB, self.BLK, self.L
        S = self.graph.num_states
        tok_state, tok_cost, tok_off, tok_cnt = tok
        B = tok_cost.shape[0]
        dev = tok_cost.device
        i64 = torch.int64

        # 0. adaptive arc-budget beam: when the block demand exceeds MB,
        #    prune whole tokens by a block-weighted cost histogram
        NBA = self._NBA
        fin_tok = torch.isfinite(tok_cost)
        demand = tok_cnt.sum(1)
        tmin = torch.where(fin_tok, tok_cost, INF).amin(1, keepdim=True)
        tb = torch.where(fin_tok, (tok_cost - tmin) * _f32(NBA / c.beam),
                         0.0).to(i64).clamp(0, NBA - 1)
        tb = torch.where(fin_tok, tb, NBA - 1)
        blk_hist = torch.zeros((B, NBA), dtype=i64, device=dev)
        blk_hist.scatter_add_(1, tb, tok_cnt)
        cut_a = ((blk_hist.cumsum(1) <= MB).sum(1) - 1).clamp_min(0)
        fits = demand <= MB
        tok_cnt = torch.where(fits[:, None] | (tb <= cut_a[:, None]),
                              tok_cnt, 0)
        eff_beam = torch.where(fits, _f32(c.beam),
                               (cut_a.to(torch.float32) + 1.0)
                               * _f32(c.beam / NBA))

        # 1. load-balanced block distribution: the owner of block slot
        #    j is searchsorted(cum, j, right)
        cum = tok_cnt.cumsum(1)
        total = cum[:, K - 1]
        j = torch.arange(MB, dtype=i64, device=dev)
        tok_of = torch.searchsorted(
            cum, j.expand(B, MB).contiguous(), right=True).clamp_max(K - 1)
        cost_sane = torch.where(fin_tok, tok_cost, 1e30)
        delta_f = (tok_off - (cum - tok_cnt)).gather(1, tok_of)
        cost_f = cost_sane.gather(1, tok_of)
        in_range = j[None, :] < total[:, None]
        dropped = ((demand - total) + (total - MB).clamp_min(0)) * blk

        # 2. expand: one MB-row gather of (blk·5)-wide block rows
        bidx = (j[None, :] + delta_f).clamp(0, g["arc_tab"].shape[0] - 1)
        rows = g["arc_tab"][bidx].view(B, M, 5)
        aidx = (bidx[:, :, None] * blk
                + torch.arange(blk, dtype=i64, device=dev)).view(B, M)

        def lane(x):
            return x[:, :, None].expand(B, MB, blk).reshape(B, M)

        c_state = rows[..., 0].to(i64)
        gw = rows[..., 1].view(torch.float32)
        ac = _f32(-c.acoustic_scale) * loglike.gather(1, rows[..., 3].to(i64))
        c_cost = torch.where(lane(in_range), (lane(cost_f) + gw) + ac, INF)

        # 3. beam prune + recombination: stable sort on (state, cost);
        #    the first candidate of each state run survives
        best = c_cost.amin(1, keepdim=True)
        fin = c_cost <= best + _f32(c.beam)
        c_cost = torch.where(fin, c_cost, INF)
        sort_state = torch.where(fin, c_state, S)
        _, perm = torch.sort((sort_state << 32) | _sortable_bits(c_cost),
                             dim=1, stable=True)
        st_s = sort_state.gather(1, perm)
        cost_s = c_cost.gather(1, perm)
        prev_s = lane(tok_of).gather(1, perm)
        aidx_s = aidx.gather(1, perm)
        first = torch.ones_like(st_s, dtype=torch.bool)
        first[:, 1:] = st_s[:, 1:] != st_s[:, :-1]
        head = first & (st_s < S)
        n_heads = head.sum(1)

        # 4. max-active via histogram cutoff, slots in state order by
        #    one cumsum; compaction scatters the (unique) slots
        NB = self._NB
        maxa = self.maxa
        hb = torch.where(head, (cost_s - best) * _f32(NB / c.beam),
                         0.0).to(i64).clamp(0, NB - 1)
        hist = torch.zeros((B, NB), dtype=i64, device=dev)
        hist.scatter_add_(1, hb, head.to(i64))
        cut_bin = ((hist.cumsum(1) <= maxa).sum(1) - 1).clamp_min(0)
        keep_head = head & ((n_heads <= maxa)[:, None]
                            | (hb <= cut_bin[:, None]))
        slot = keep_head.to(i64).cumsum(1) - 1
        valid = keep_head & (slot < maxa)
        dst_idx = torch.where(valid, slot, K)      # column K: discarded

        def compact(x, fill):
            out = torch.full((B, K + 1), fill, dtype=x.dtype, device=dev)
            return out.scatter_(1, dst_idx, x)[:, :K]

        new_state = compact(st_s, -1)
        ok = new_state >= 0
        new_cost = compact(cost_s, INF)
        sb = g["state_blk"][new_state.clamp_min(0)].to(i64)
        new_off = torch.where(ok, sb[..., 0], 0)
        new_cnt = torch.where(ok, sb[..., 1], 0)
        vit = (compact(prev_s, -1), compact(aidx_s, -1))
        new_tok = (new_state, new_cost, new_off, new_cnt)
        diag = (demand * blk, n_heads, eff_beam)
        if not L:
            return new_tok, vit, None, dropped, diag

        # 5. lattice records: every candidate within lattice_beam of its
        #    (surviving) segment head, ordered by extra cost
        pos = torch.arange(M, dtype=i64, device=dev)
        last_head = torch.where(head, pos, -1).cummax(1).values
        seg_cost = torch.where(valid, cost_s, INF).gather(
            1, last_head.clamp_min(0))
        extra = cost_s - seg_cost
        keep = (torch.isfinite(cost_s) & torch.isfinite(seg_cost)
                & (extra <= _f32(c.lattice_beam)))
        key3 = torch.where(keep, extra, INF)
        _, p3 = torch.sort(_sortable_bits(key3), dim=1, stable=True)
        p3 = p3[:, :min(M, L)]

        def fit(x, fill):
            x = x.gather(1, p3)
            if M >= L:
                return x
            return torch.cat([x, torch.full((B, L - M), fill, dtype=x.dtype,
                                            device=dev)], dim=1)

        rvalid = torch.isfinite(fit(key3, INF))
        dst_slot = slot.clamp(0, K - 1)
        if self._pack_pd:
            pd = torch.where(keep, (prev_s << self._tok_bits) | dst_slot, -1)
            cols = [torch.where(rvalid, fit(pd, -1), -1),
                    torch.where(rvalid, fit(aidx_s, 0), 0)]
        else:
            cols = [torch.where(rvalid, fit(prev_s, 0), -1),
                    torch.where(rvalid, fit(dst_slot, -1), 0),
                    torch.where(rvalid, fit(aidx_s, 0), 0)]
        chunk = torch.stack(cols, dim=-1).to(torch.int32)
        if with_cost:
            # forward path cost α(prev)+w: a device-only column the β
            # pass reads
            cb = cost_s.view(torch.int32)
            inf_b = int(np.float32(np.inf).view(np.int32))
            cbc = torch.where(rvalid, fit(cb, inf_b), inf_b)
            chunk = torch.cat([chunk, cbc[:, :, None]], dim=-1)
        return new_tok, vit, chunk, dropped, diag

    def _frame_step(self, tok, loglike, act, with_cost=False):
        """One frame for a batch, an identity step where ``act`` (B,) is
        false: tok = (state, cost, off, cnt), each (B, K); loglike (B,
        P).  Returns (new tok, Viterbi rows (prev, aidx), record chunk
        (B, L, w) | None, α (B, K), dropped (B,), (arcs_demand, n_heads,
        eff_beam)).  With ``with_cost`` the chunk carries the cost column
        the β pass reads and an inactive frame's chunk is all invalid;
        α is the source tokens' costs, the β pass's other input."""
        new_tok, vit, chunk, drop, diag = self._sweep(tok, loglike,
                                                      with_cost=with_cost)
        act2 = act[:, None]
        new_tok = tuple(torch.where(act2, n, o) for n, o in zip(new_tok, tok))
        vit = (torch.where(act2, vit[0], self._idn),
               torch.where(act2, vit[1], -1))
        diag = (torch.where(act, diag[0], 0), torch.where(act, diag[1], 0),
                torch.where(act, diag[2], _f32(self.config.beam)))
        if chunk is not None and with_cost:
            chunk[..., 0] = torch.where(act2, chunk[..., 0], -1)
        return (new_tok, vit, chunk, tok[1], torch.where(act, drop, 0),
                diag)

    def _finals(self, fs, fc):
        """Final tokens (state, cost), each (B, K) → (each token's final
        cost, live mask, any_final (B, 1), use): ``use`` is the cost with
        the final cost added where any token is final, else without."""
        okf = fs >= 0
        fin = self._g["final"][fs.clamp_min(0)]
        total = torch.where(okf, fc + fin, INF)
        any_final = torch.isfinite(total).any(1, keepdim=True)
        use = torch.where(any_final, total, torch.where(okf, fc, INF))
        return fin, okf, any_final, use

    def _decode_batch(self, loglikes: torch.Tensor,
                      num_frames: torch.Tensor) -> Dict:
        """(B, T_pad, P) float32 + (B,) int64, both on the decoder's
        device → dict of device tensors.  Issues device work only: no
        host synchronisation inside the frame loops."""
        g = self._g
        c = self.config
        K, L = self.K, self.L
        B, T_pad, _ = loglikes.shape
        dev = loglikes.device
        i32, i64 = torch.int32, torch.int64
        use_beta = self._use_beta(B, T_pad)
        active = (torch.arange(T_pad, device=dev)[None, :]
                  < num_frames[:, None])
        tok = (g["init_state"].to(i64).expand(B, K),
               g["init_cost"].expand(B, K),
               g["init_off"].to(i64).expand(B, K),
               g["init_cnt"].to(i64).expand(B, K))
        vit_prev = torch.empty((B, T_pad, K), dtype=i32, device=dev)
        vit_aidx = torch.empty((B, T_pad, K), dtype=i32, device=dev)
        dropped = torch.zeros((B, T_pad), dtype=i64, device=dev)
        arcs_demand = torch.zeros((B, T_pad), dtype=i64, device=dev)
        n_heads = torch.zeros((B, T_pad), dtype=i64, device=dev)
        eff_beam = torch.full((B, T_pad), _f32(c.beam), device=dev)
        if L:
            w = self._recw + (1 if use_beta else 0)
            chunks = torch.empty((B, T_pad, L, w), dtype=i32, device=dev)
            counts = torch.zeros((B, T_pad), dtype=i64, device=dev)
        if use_beta:
            alphas = torch.empty((B, T_pad, K), dtype=torch.float32,
                                 device=dev)

        for t in range(T_pad):
            act = active[:, t]
            tok, vit, chunk, alpha, drop, diag = self._frame_step(
                tok, loglikes[:, t], act, with_cost=use_beta)
            if use_beta:
                alphas[:, t] = alpha
            vit_prev[:, t] = vit[0]
            vit_aidx[:, t] = vit[1]
            dropped[:, t] = drop
            arcs_demand[:, t] = diag[0]
            n_heads[:, t] = diag[1]
            eff_beam[:, t] = diag[2]
            if chunk is not None:
                if not use_beta:
                    counts[:, t] = torch.where(
                        act, (chunk[..., 0] >= 0).sum(1), 0)
                chunks[:, t] = chunk

        fs, fc = tok[0], tok[1]
        fin, okf, any_final, use = self._finals(fs, fc)
        best_idx = use.argmin(1)
        best_cost = use.gather(1, best_idx[:, None])[:, 0]

        # Viterbi backtrace on the device: only the (B, T) winning
        # arc-index paths leave it
        idx = best_idx
        bt_aidx = torch.empty((B, T_pad), dtype=i32, device=dev)
        for t in range(T_pad - 1, -1, -1):
            live = idx >= 0
            i = idx.clamp_min(0)[:, None]
            bt_aidx[:, t] = torch.where(
                live, vit_aidx[:, t].gather(1, i)[:, 0], -1)
            idx = torch.where(live, vit_prev[:, t].gather(1, i)[:, 0].to(i64),
                              idx)
        out = {
            "bt_aidx": bt_aidx, "bt_end": idx,
            "dropped_arcs": dropped.sum(1),
            "max_arcs_demand": arcs_demand.amax(1),
            "max_heads": n_heads.amax(1),
            "min_eff_beam": eff_beam.amin(1),
            "beam_deficit": (_f32(c.lattice_beam) - eff_beam)
            .clamp_min(0.0).sum(1),
            "best_idx": best_idx, "best_cost": best_cost,
            "final_cost": torch.where(any_final[:, 0],
                                      fin.gather(1, best_idx[:, None])[:, 0],
                                      0.0),
            "tok_state": fs, "tok_cost": fc, "tok_final": fin,
            "rec_reversed": 1 if use_beta else 0,
        }
        if use_beta:
            chunks, counts = self._beta_pass(chunks, alphas, active, fs, fc)
        if L:
            out["rec_chunks"] = chunks
            out["rec_counts"] = counts
        return out

    def _beta_pass(self, chunks, alphas, active, fs, fc):
        """Reverse (β) pass over stored records: chunks (B, T, L, w+1)
        with the cost column, α (B, T, K), the frame mask (B, T) and the
        final tokens (state, cost), each (B, K), of an offline batch or
        of a stream (decoder/online_beam.py).  Per frame keep the
        records on complete paths within best + lattice_beam +
        beta_prune_margin (packed to a prefix, original order) and
        propagate β[t][prev] = min over prev's candidates of
        (α(prev)+w + β[t+1][dst]) − α[t][prev], from β = each token's
        final cost where any token is final, else 0."""
        c = self.config
        K = self.K
        B, T_pad, L, _ = chunks.shape
        w = self._recw
        dev = chunks.device
        i64 = torch.int64
        fin, okf, any_final, use = self._finals(fs, fc)
        bound = use.amin(1) + _f32(c.lattice_beam + c.beta_prune_margin)
        beta = torch.where(okf, torch.where(any_final, fin, 0.0), INF)
        kept = torch.empty((B, T_pad, L, w), dtype=torch.int32, device=dev)
        counts = torch.zeros((B, T_pad), dtype=i64, device=dev)
        for t in range(T_pad - 1, -1, -1):
            ch = chunks[:, t]
            pd0 = ch[..., 0].to(i64)
            valid = pd0 >= 0
            if self._pack_pd:
                prev = (pd0 >> self._tok_bits).clamp(0, K - 1)
                dst = (pd0 & ((1 << self._tok_bits) - 1)).clamp(0, K - 1)
            else:
                prev = pd0.clamp(0, K - 1)
                dst = ch[..., 1].to(i64).clamp(0, K - 1)
            fc = ch[..., w].view(torch.float32)
            v = torch.where(valid, fc + beta.gather(1, dst), INF)
            act = active[:, t]
            keep = valid & (v <= bound[:, None]) & act[:, None]
            slot = torch.where(keep, keep.to(i64).cumsum(1) - 1, L)
            rows = torch.zeros((B, L + 1, w), dtype=torch.int32, device=dev)
            rows[..., 0] = -1
            rows.scatter_(1, slot[:, :, None].expand(B, L, w), ch[..., :w])
            kept[:, t] = rows[:, :L]
            counts[:, t] = keep.sum(1)
            bsum = torch.full((B, K), INF, device=dev).scatter_reduce_(
                1, prev, v, reduce="amin")
            a_t = alphas[:, t]
            nb = torch.where(torch.isfinite(bsum) & torch.isfinite(a_t),
                             bsum - a_t, INF)
            beta = torch.where(act[:, None], nb, beta)
        return kept, counts

    @staticmethod
    def _compact(chunks: torch.Tensor, counts: torch.Tensor,
                 reverse: bool, total: int) -> torch.Tensor:
        """(B, T_pad, L, w) per-frame record prefixes + (B, T_pad)
        counts → (total, w): each utterance's records back to back, its
        frame segments in forward order (reverse order when
        ``reverse``, the β pass's layout)."""
        B, T_pad = counts.shape
        c = (counts.flip(1) if reverse else counts).reshape(-1)
        cum = c.cumsum(0)
        r = torch.arange(total, dtype=torch.int64, device=chunks.device)
        seg = torch.searchsorted(cum, r, right=True)
        off = r - (cum[seg] - c[seg])
        b = seg // T_pad
        t = seg % T_pad
        if reverse:
            t = T_pad - 1 - t
        return chunks[b, t, off]

    # ------------------------------------------------------------------
    # host side
    # ------------------------------------------------------------------

    _SMALL_KEYS = ("bt_aidx", "bt_end", "best_cost",
                   "final_cost", "dropped_arcs", "tok_final",
                   "min_eff_beam", "beam_deficit",
                   "max_arcs_demand", "max_heads")

    def _check_overflow(self, n, cap):
        if n > cap:
            raise KaldiError(
                f"BeamDecoder: record_capacity overflow ({n} records > "
                f"{cap}); raise record_capacity or lattice_arcs_per_frame")

    def _fetch_batch(self, out, lattice=False) -> List[Dict]:
        """Device outputs → one host dict per utterance, in the layout
        the original's ``_fetch_batch`` gives: records of utterance b
        are its per-frame prefixes back to back."""
        small = {k: out[k].cpu().numpy() for k in self._SMALL_KEYS}
        B = small["best_cost"].shape[0]
        hosts = [{k: small[k][b] for k in self._SMALL_KEYS}
                 for b in range(B)]
        for h in hosts:
            h["rec_reversed"] = out["rec_reversed"]
        if lattice:
            counts = out["rec_counts"].cpu().numpy()
            ns = counts.sum(axis=1)
            T_pad = counts.shape[1]
            rcap = self.config.record_capacity or (T_pad * self.L)
            self._check_overflow(int(ns.max()), min(rcap, T_pad * self.L))
            cum = np.zeros(B + 1, np.int64)
            np.cumsum(ns, out=cum[1:])
            flat = self._compact(out["rec_chunks"], out["rec_counts"],
                                 bool(out["rec_reversed"]),
                                 int(cum[-1])).cpu().numpy()
            for b in range(B):
                hosts[b]["rec_counts"] = counts[b]
                hosts[b]["rec_packed"] = flat[cum[b]:cum[b + 1]]
        return hosts

    def _to_device(self, loglikes, num_frames):
        ll = torch.as_tensor(loglikes, dtype=torch.float32).to(self.device)
        nf = torch.as_tensor(np.asarray(num_frames, np.int64)).to(self.device)
        return ll, nf

    @staticmethod
    def _host_array(loglikes) -> np.ndarray:
        if isinstance(loglikes, torch.Tensor):
            return loglikes.detach().cpu().numpy().astype(np.float32)
        return np.asarray(loglikes, np.float32)

    def _decode_host(self, loglikes, num_frames, lattice=False):
        ll, nf = self._to_device(loglikes, num_frames)
        return self._fetch_batch(self._decode_batch(ll, nf), lattice=lattice)

    # -- demand-triggered escalation (the retry-beam contract) -------------

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder.deficit_fires.
    def deficit_fires(self, deficit: float) -> bool:
        c = self.config
        if not c.escalate_budget or c.escalate_budget <= self.M:
            return False
        return float(deficit) > c.escalate_deficit

    def needs_escalation(self, host) -> bool:
        return self.deficit_fires(host["beam_deficit"])

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder._escalator.
    def _escalator(self) -> "BeamDecoder":
        esc = self._esc
        if esc is None:
            c = self.config
            esc_L = (max(self.L, min(4096, c.escalate_budget))
                     if self.L else 0)
            esc = self.with_overrides(
                arc_budget=c.escalate_budget, escalate_budget=0,
                lattice_arcs_per_frame=esc_L,
                record_capacity=(max(2 * c.record_capacity, esc_L)
                                 if c.record_capacity else 0))
            self._esc = esc
        return esc

    # Port of kaldi_tpu/decoder/beam.py BeamDecoder._maybe_escalate.
    def _maybe_escalate(self, host, ll_padded: np.ndarray, T: int,
                        lattice: bool = True):
        """Re-decode one utterance at the escalated budget when the
        deficit trigger fires; returns (host, decoder-that-decoded)."""
        if not self.needs_escalation(host):
            return host, self
        esc = self._escalator()
        return esc._decode_host(ll_padded[None], [T], lattice=lattice)[0], esc

    def decode_compact_batch(self, loglikes_padded, num_frames: np.ndarray,
                             pool=None, stats: Optional[Dict] = None):
        """(B, T_pad, P) (numpy, or a tensor on any device) + (B,) →
        determinized CompactLattices with escalation and host lattice
        builds optionally fanned over ``pool``.  Pass a dict as
        ``stats`` to receive min_eff_beam / n_escalated / dropped_arcs /
        peak-occupancy diagnostics."""
        if not self.L:
            raise KaldiError("decode_compact_batch needs "
                             "lattice_arcs_per_frame")
        ll_host = self._host_array(loglikes_padded)
        num_frames = np.asarray(num_frames)
        hosts = self._decode_host(loglikes_padded, num_frames, lattice=True)
        return self.compact_lattices(hosts, ll_host, num_frames, pool, stats)

    def compact_lattices(self, hosts: List[Dict], ll_host: np.ndarray,
                         num_frames: np.ndarray, pool=None,
                         stats: Optional[Dict] = None):
        """The fetched rows ``hosts`` (``_decode_host(..., lattice=True)``;
        the first len(hosts) rows of ``ll_host`` and ``num_frames``) →
        determinized CompactLattices, each re-decoded at the escalated
        budget when its deficit trigger fires; ``stats`` as in
        ``decode_compact_batch``."""
        if stats is not None:
            stats.setdefault("min_eff_beam", float("inf"))
            stats.setdefault("n_escalated", 0)
            stats.setdefault("dropped_arcs", 0)
            stats["arcs_peak"] = max(stats.get("arcs_peak", 0), max(
                (int(h["max_arcs_demand"]) for h in hosts), default=0))
            stats["heads_peak"] = max(stats.get("heads_peak", 0), max(
                (int(h["max_heads"]) for h in hosts), default=0))
        futs = []
        for b, host in enumerate(hosts):
            T = int(num_frames[b])
            host, dec = self._maybe_escalate(host, ll_host[b], T)
            if stats is not None:
                stats["min_eff_beam"] = min(stats["min_eff_beam"],
                                            float(host["min_eff_beam"]))
                stats["n_escalated"] += int(dec is not self)
                stats["dropped_arcs"] += int(host["dropped_arcs"])
            if pool is None:
                futs.append(dec.build_compact_lattice(host, T, ll_host[b]))
            else:
                futs.append(pool.submit(dec.build_compact_lattice, host, T,
                                        ll_host[b]))
        return [f.result() for f in futs] if pool is not None else futs

    def decode(self, loglikes) -> Tuple[List[int], List[int], float]:
        """Single utterance → (tid alignment, olabel seq, total cost)."""
        T = loglikes.shape[0]
        return self._backtrace(self._decode_host(loglikes[None], [T])[0], T)

    # Port of kaldi_tpu/decoder/beam.py BeamDecoder.decode_batch.
    def decode_batch(self, loglikes_padded, num_frames: np.ndarray
                     ) -> List[Tuple[List[int], List[int], float]]:
        """(B, T_pad, P) + (B,) → list of (tids, olabels, cost)."""
        num_frames = np.asarray(num_frames)
        hosts = self._decode_host(loglikes_padded, num_frames)
        return [self._backtrace(h, int(num_frames[b]))
                for b, h in enumerate(hosts)]

    # Port of kaldi_tpu/decoder/beam.py BeamDecoder.decode_lattice_batch.
    def decode_lattice_batch(self, loglikes_padded, num_frames: np.ndarray
                             ) -> List[Lattice]:
        """(B, T_pad, P) + (B,) → one pruned raw Lattice per utterance,
        each re-decoded at the escalated budget when its deficit
        trigger fires."""
        if not self.L:
            raise KaldiError("decode_lattice needs lattice_arcs_per_frame")
        ll_host = self._host_array(loglikes_padded)
        num_frames = np.asarray(num_frames)
        hosts = self._decode_host(loglikes_padded, num_frames, lattice=True)
        lats = []
        for b, h in enumerate(hosts):
            T = int(num_frames[b])
            h, dec = self._maybe_escalate(h, ll_host[b], T)
            lats.append(dec._build_lattice(h, T, ll_host[b]))
        return lats

    def decode_lattice(self, loglikes) -> Lattice:
        """Single utterance → pruned raw Lattice."""
        if not self.L:
            raise KaldiError("decode_lattice needs lattice_arcs_per_frame")
        ll = self._host_array(loglikes)
        T = ll.shape[0]
        host = self._decode_host(ll[None], [T], lattice=True)[0]
        host, dec = self._maybe_escalate(host, ll, T)
        return dec._build_lattice(host, T, ll)

    def decode_compact(self, loglikes, bucket: int = 64,
                       max_states: int = 200000):
        """Single utterance → determinized CompactLattice (frames padded
        to a ``bucket`` multiple, as in the original)."""
        if not self.L:
            raise KaldiError("decode_compact needs lattice_arcs_per_frame")
        ll = self._host_array(loglikes)
        T = ll.shape[0]
        if bucket > 1 and T % bucket:
            pad = bucket - T % bucket
            ll = np.concatenate(
                [ll, np.zeros((pad, ll.shape[1]), np.float32)])
        host = self._decode_host(ll[None], [T], lattice=True)[0]
        host, dec = self._maybe_escalate(host, ll, T)
        return dec.build_compact_lattice(host, T, ll, max_states=max_states)

    # -- Viterbi backtrace -------------------------------------------------

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder._backtrace.
    def _backtrace(self, host, T: int):
        best_cost = float(host["best_cost"])
        if not np.isfinite(best_cost):
            raise KaldiError("BeamDecoder: no tokens survived")
        start_slot = int(host["bt_end"])
        if start_slot < 0:
            raise KaldiError("BeamDecoder: broken backpointer chain")
        aidx = np.asarray(host["bt_aidx"][:T])
        aidx = aidx[aidx >= 0]
        tids = [int(t) for t in self._flat[aidx, 2] if t]
        ols = list(self._expand_ol(int(self._init_ols[start_slot])))
        for o in self._flat[aidx, 4]:
            if o:
                ols.extend(self._expand_ol(int(o)))
        return tids, ols, best_cost

    def _expand_ol(self, ol: int):
        from kaldi_tpu_torch.fst.csr import expand_olabel
        return expand_olabel(ol, self._ol_seqs)

    # -- lattice assembly (vectorized, no per-arc Python) ------------------

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder._decode_records.
    def _decode_records(self, host, T: int, loglikes: np.ndarray):
        """Packed device records → flat arc-field arrays: (counts,
        prev, dst, il, ol, gw, ac, init_slots, init_costs, init_ols)."""
        counts = host["rec_counts"][:T]
        packed = host["rec_packed"]
        if int(host.get("rec_reversed", 0)):
            # the β pass appends frame segments in REVERSE order
            counts = np.asarray(counts, np.int64)
            n = int(counts.sum())
            packed = packed[:n]
            fwd_offs = np.zeros(T + 1, np.int64)
            np.cumsum(counts, out=fwd_offs[1:])
            starts_rev = n - fwd_offs[1:]
            delta = np.repeat(starts_rev - fwd_offs[:-1], counts)
            packed = packed[np.arange(n) + delta]
        if self._pack_pd:
            r_prev = packed[:, 0] >> self._tok_bits
            r_dst = packed[:, 0] & ((1 << self._tok_bits) - 1)
            aidx = packed[:, 1]
        else:
            r_prev, r_dst, aidx = (packed[:, 0], packed[:, 1],
                                   packed[:, 2])
        flat = self._flat
        r_il = flat[aidx, 2]
        r_ol = flat[aidx, 4]
        r_gw = flat[aidx, 1].view(np.float32)
        t_of = np.repeat(np.arange(T), counts)
        ll = np.asarray(loglikes, np.float32)
        r_ac = np.float32(-self.config.acoustic_scale) \
            * ll[t_of, flat[aidx, 3]]
        init_cost = self._g_host["init_cost"]
        init_slots = np.nonzero(np.isfinite(init_cost))[0].astype(np.int32)
        return (counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
                init_slots, init_cost[init_slots],
                self._init_ols[init_slots].astype(np.int32))

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder._expand_arc_ols.
    def _expand_arc_ols(self, ks, kd, kil, kol, kgw, kac, n_states):
        """Split arcs whose olabel is sequence-encoded into chains of
        plain word olabels before determinization."""
        from kaldi_tpu_torch.fst.csr import OLSEQ_BASE
        if not self._ol_seqs or not len(kol):
            return ks, kd, kil, kol, kgw, kac, n_states
        enc = np.nonzero(np.asarray(kol) >= OLSEQ_BASE)[0]
        if not len(enc):
            return ks, kd, kil, kol, kgw, kac, n_states
        ks = list(np.asarray(ks)); kd = list(np.asarray(kd))
        kil = list(np.asarray(kil)); kol = list(np.asarray(kol))
        kgw = list(np.asarray(kgw)); kac = list(np.asarray(kac))
        for i in enc:
            seq = self._ol_seqs[int(kol[i]) - OLSEQ_BASE]
            dst = kd[i]
            kol[i] = seq[0]
            prev = n_states
            kd[i] = prev
            n_states += len(seq) - 1
            for j, wid in enumerate(seq[1:]):
                last = j == len(seq) - 2
                ks.append(prev); kd.append(dst if last else prev + 1)
                kil.append(0); kol.append(wid)
                kgw.append(0.0); kac.append(0.0)
                prev += 1
        return (np.asarray(ks, np.int32), np.asarray(kd, np.int32),
                np.asarray(kil, np.int32), np.asarray(kol, np.int32),
                np.asarray(kgw, np.float32), np.asarray(kac, np.float32),
                n_states)

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder.build_compact_lattice
    # (without its stage timers).
    def build_compact_lattice(self, host, T: int, loglikes: np.ndarray,
                              max_states: int = 200000):
        """Records → determinized CompactLattice through the native
        build + determinize passes; falls back to _build_lattice +
        determinize_lattice when the native library is unavailable."""
        from kaldi_tpu_torch import native
        from kaldi_tpu_torch.lattice.determinize import (
            compact_from_arrays, determinize_lattice)
        (counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
         init_slots, init_costs, init_ols) = \
            self._decode_records(host, T, loglikes)
        res = native.build_lattice_native(
            counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
            init_slots, init_costs, init_ols, host["tok_final"],
            self.config.lattice_beam)
        if res is not None:
            (ks, kd, kil, kol, kgw, kac, fs, fw, n_kept) = res
            (ks, kd, kil, kol, kgw, kac, n_kept) = self._expand_arc_ols(
                ks, kd, kil, kol, kgw, kac, n_kept)
            det = native.determinize_lattice_native(
                n_kept, 0, ks, kd, kil, kol, kgw, kac,
                fs, fw, np.zeros(len(fw), np.float32),
                max_states=max_states)
            if det is not None:
                return compact_from_arrays(det)
        return determinize_lattice(self._build_lattice(host, T, loglikes),
                                   max_states=max_states)

    # Copied from kaldi_tpu/decoder/beam.py BeamDecoder._build_lattice.
    def _build_lattice(self, host, T: int,
                       loglikes: np.ndarray) -> Lattice:
        K = self.K
        beam = self.config.lattice_beam
        (counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
         init_slots, init_costs, init_ols) = \
            self._decode_records(host, T, loglikes)
        offs = np.zeros(T + 1, np.int64)
        np.cumsum(counts, out=offs[1:])

        from kaldi_tpu_torch import native
        res = native.build_lattice_native(
            counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
            init_slots, init_costs, init_ols, host["tok_final"], beam)
        if res is not None:
            (ks, kd, kil, kol, kgw, kac, fs, fw, n_kept) = res
            (ks, kd, kil, kol, kgw, kac, n_kept) = self._expand_arc_ols(
                ks, kd, kil, kol, kgw, kac, n_kept)
            lat = Lattice()
            for _ in range(n_kept):
                lat.add_state()
            lat.start = 0
            for i in range(len(ks)):
                lat.arcs[ks[i]].append(LatticeArc(
                    int(kil[i]), int(kol[i]), float(kgw[i]),
                    float(kac[i]), int(kd[i])))
            for s, wgt in zip(fs, fw):
                lat.set_final(int(s), float(wgt), 0.0)
            return lat

        # level 0: the initial token set, connected from a virtual start
        init_cost = self._g_host["init_cost"]
        init_slots = np.nonzero(np.isfinite(init_cost))[0]
        cur = np.full(K, -1, np.int64)
        cur[init_slots] = 1 + np.arange(len(init_slots))
        n_states = 1 + len(init_slots)
        arcs_src: List[np.ndarray] = [np.zeros(len(init_slots), np.int64)]
        arcs_dst: List[np.ndarray] = [cur[init_slots]]
        arcs_il: List[np.ndarray] = [np.zeros(len(init_slots), np.int32)]
        arcs_ol: List[np.ndarray] = [
            self._init_ols[init_slots].astype(np.int32)]
        arcs_gw: List[np.ndarray] = [init_cost[init_slots]]
        arcs_ac: List[np.ndarray] = [np.zeros(len(init_slots), np.float32)]
        level_sizes: List[int] = [len(init_slots)]
        for t in range(T):
            sl = slice(offs[t], offs[t + 1])
            prev = r_prev[sl]
            valid = cur[prev] >= 0
            dst = r_dst[sl][valid]
            uniq = np.unique(dst)
            new = np.full(K, -1, np.int64)
            new[uniq] = n_states + np.arange(len(uniq))
            n_states += len(uniq)
            arcs_src.append(cur[prev[valid]])
            arcs_dst.append(new[dst])
            arcs_il.append(r_il[sl][valid])
            arcs_ol.append(r_ol[sl][valid])
            arcs_gw.append(r_gw[sl][valid])
            arcs_ac.append(r_ac[sl][valid])
            level_sizes.append(int(valid.sum()))
            cur = new
        src = np.concatenate(arcs_src)
        dst = np.concatenate(arcs_dst)
        il = np.concatenate(arcs_il)
        ol = np.concatenate(arcs_ol)
        gw = np.concatenate(arcs_gw).astype(np.float64)
        ac = np.concatenate(arcs_ac).astype(np.float64)
        w = gw + ac

        fin_slots = np.nonzero((cur >= 0)
                               & np.isfinite(host["tok_final"]))[0]
        fin_states = cur[fin_slots]
        fin_w = host["tok_final"][fin_slots].astype(np.float64)
        if len(fin_states) == 0:   # no token reached a final state
            fin_states = cur[np.nonzero(cur >= 0)[0]]
            fin_w = np.zeros(len(fin_states))

        alpha = np.full(n_states, np.inf)
        alpha[0] = 0.0
        pos = 0
        for n in level_sizes:
            sl = slice(pos, pos + n)
            np.minimum.at(alpha, dst[sl], alpha[src[sl]] + w[sl])
            pos += n
        beta = np.full(n_states, np.inf)
        np.minimum.at(beta, fin_states, fin_w)
        pos = len(src)
        for n in reversed(level_sizes):
            sl = slice(pos - n, pos)
            np.minimum.at(beta, src[sl], w[sl] + beta[dst[sl]])
            pos -= n
        best = alpha[fin_states] + fin_w
        if not len(best) or not np.isfinite(best.min()):
            raise KaldiError("BeamDecoder: empty lattice")
        bound = best.min() + beam

        keep_arc = alpha[src] + w + beta[dst] <= bound
        keep_state = np.zeros(n_states, bool)
        keep_state[0] = True
        keep_state[src[keep_arc]] = True
        keep_state[dst[keep_arc]] = True
        remap = np.cumsum(keep_state) - 1

        ks = remap[src[keep_arc]]
        kd = remap[dst[keep_arc]]
        kil = il[keep_arc]
        kol = ol[keep_arc]
        kgw = gw[keep_arc]
        kac = ac[keep_arc]
        n_kept = int(keep_state.sum())
        (ks, kd, kil, kol, kgw, kac, n_kept) = self._expand_arc_ols(
            ks, kd, kil, kol, kgw, kac, n_kept)
        lat = Lattice()
        for _ in range(n_kept):
            lat.add_state()
        lat.start = 0
        for i in range(len(ks)):
            lat.arcs[ks[i]].append(LatticeArc(
                int(kil[i]), int(kol[i]), float(kgw[i]), float(kac[i]),
                int(kd[i])))
        fk = keep_state[fin_states] & (alpha[fin_states] + fin_w <= bound)
        for s, wgt in zip(fin_states[fk], fin_w[fk]):
            lat.set_final(int(remap[s]), float(wgt), 0.0)
        return lat
