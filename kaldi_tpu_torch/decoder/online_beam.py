"""Streaming large-graph decoding (LatticeFasterOnlineDecoder role), in
PyTorch.

Port of kaldi_tpu/decoder/online_beam.py (parity target
src/decoder/lattice-faster-online-decoder.h): ``advance`` consumes score
chunks as they arrive, ``partial`` / ``get_best_path`` give the best path
at any time, and ``finalize`` returns the determinized CompactLattice.
The chunk step is the offline decoder's ``BeamDecoder._frame_step`` with
the token set carried across chunks; every frame's Viterbi rows, record
chunk (β layout, with the cost column) and source-token costs are
written into device buffers of ``max_frames`` rows, so that

  * a partial traceback walks the filled prefix on the device with
    gathers, one frame at a time, and only the winning arc-index path
    leaves it;
  * ``finalize`` runs the decoder's β pass over the stored buffers and
    fetches only the records the final lattice keeps, then the host
    lattice build and determinize of the offline path.

What changed from the original: the fixed-shape padded chunk that served
XLA's compile cache is gone (a chunk step runs the frames it has), and so
are ``prewarm_finalize_beta`` and the finalize-β compile cache; the
stream's log-likelihoods stay on the device until ``finalize``.  N
streams (``MultiStreamBeamDecoder``) are one batched frame step over the
lanes; each lane writes its rows at its own frame count, a device
tensor, and a lane with no frames in a step takes the identity step and
writes only to a spare row.  Two faults of the original are repaired to
its intent: ``_path_olabels`` raises on a broken backpointer chain
(slot < 0) as the offline ``_backtrace`` does, and the stream buffers
are checked against a quarter of the device's memory, as the offline
β-prune's are, before they are allocated.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.decoder.beam import BeamDecoder, _f32

log = get_logger(__name__)


def _put_rows(buf: torch.Tensor, row: torch.Tensor, val: torch.Tensor):
    """buf[n, row[n]] = val[n] for every lane n: a scatter along dim 1,
    which needs no host synchronisation."""
    shape = (val.shape[0], 1) + tuple(val.shape[1:])
    idx = row.view((-1, 1) + (1,) * (val.dim() - 1)).expand(shape)
    buf.scatter_(1, idx, val.unsqueeze(1).to(buf.dtype))


class _Streams:
    """Device state of N streams on one BeamDecoder: carried tokens,
    per-frame Viterbi rows, β-layout record chunks and source-token costs
    (row ``max_frames`` of each buffer is a spare that inactive frames
    write), the beam deficit, and each stream's frame count on the device
    (``fd``) and on the host (``frames``)."""

    def __init__(self, dec: BeamDecoder, n: int, max_frames: int):
        if not dec.L:
            raise KaldiError("streaming decode needs lattice_arcs_per_frame "
                             "on the BeamDecoder")
        need = n * max_frames * (dec.L * (dec._recw + 1) + 3 * dec.K) * 4
        if need > dec._memory_bytes() // 4:
            raise KaldiError(
                f"streaming buffers of {n} streams × {max_frames} frames "
                f"need {need / 2 ** 30:.1f} GiB, more than a quarter of "
                f"{dec.device}'s memory; lower max_frames or the lanes")
        self.dec = dec
        self.maxT = max_frames
        dev = dec.device
        K, rows = dec.K, max_frames + 1
        i32 = torch.int32
        self.all_active = torch.ones(n, dtype=torch.bool, device=dev)
        # copies, not views of the graph's init tensors: reset_channel
        # writes into them
        g = dec._g
        self.tok = tuple(g[k].to(torch.int64 if k != "init_cost"
                                 else torch.float32).expand(n, K).clone()
                         for k in ("init_state", "init_cost", "init_off",
                                   "init_cnt"))
        self.chunks = torch.zeros((n, rows, dec.L, dec._recw + 1), dtype=i32,
                                  device=dev)
        self.alphas = torch.full((n, rows, K), float("inf"), device=dev)
        self.bpp = torch.zeros((n, rows, K), dtype=i32, device=dev)
        self.bpa = torch.full((n, rows, K), -1, dtype=i32, device=dev)
        self.deficit = torch.zeros(n, device=dev)
        self.fd = torch.zeros(n, dtype=torch.int64, device=dev)
        self.frames = np.zeros(n, np.int64)

    def reset(self, c: int) -> None:
        g = self.dec._g
        for t, k in zip(self.tok, ("init_state", "init_cost", "init_off",
                                   "init_cnt")):
            t[c] = g[k]
        self.bpa[c] = -1
        self.deficit[c] = 0.0
        self.fd[c] = 0
        self.frames[c] = 0

    def step(self, X: torch.Tensor, nv: np.ndarray) -> None:
        """X (N, C, P) float32 on the device; lane n consumes its first
        nv[n] frames.  Issues device work only."""
        nv = np.asarray(nv, np.int64)
        if int((self.frames + nv).max()) > self.maxT:
            raise KaldiError(f"streaming decode: max_frames ({self.maxT}) "
                             "exceeded")
        n_steps = int(nv.max())
        if n_steps == 0:
            return
        dec = self.dec
        uniform = bool((nv == n_steps).all())
        nv_dev = None
        if not uniform:
            nv_t = torch.from_numpy(nv)
            if self.fd.device.type == "cuda":
                nv_t = nv_t.pin_memory()
            nv_dev = nv_t.to(self.fd.device, non_blocking=True)
        lb = _f32(dec.config.lattice_beam)
        tok = self.tok
        deficit = []
        for t in range(n_steps):
            act = self.all_active if uniform else t < nv_dev
            tok, vit, chunk, alpha, _, diag = dec._frame_step(
                tok, X[:, t], act, with_cost=True)
            row = self.fd + t
            d = (lb - diag[2]).clamp_min(0.0)
            if not uniform:
                # inactive lanes write the spare row and add nothing
                row = torch.where(act, row, self.maxT)
                d = torch.where(act, d, 0.0)
            _put_rows(self.bpp, row, vit[0])
            _put_rows(self.bpa, row, vit[1])
            _put_rows(self.chunks, row, chunk)
            _put_rows(self.alphas, row, alpha)
            deficit.append(d)
        self.tok = tok
        self.deficit += torch.stack(deficit, 1).sum(1)
        self.fd += n_steps if uniform else nv_dev
        self.frames += nv

    def best(self):
        """Per lane: (each token's final cost (N, K), best slot (N,), its
        cost (N,)), with the final cost where any token is final."""
        fin, _, _, use = self.dec._finals(self.tok[0], self.tok[1])
        best = use.argmin(1)
        return fin, best, use.gather(1, best[:, None])[:, 0]

    def traceback(self, c: int):
        """Lane c's winning arc-index path over its filled prefix (one
        gather step per frame on the device) → (path (T,) int32 on the
        host, the path's slot before frame 0, best cost)."""
        T = int(self.frames[c])
        _, best, cost = self.best()
        idx = best[c]
        path = torch.empty(T, dtype=torch.int32, device=idx.device)
        for t in range(T - 1, -1, -1):
            live = idx >= 0
            i = idx.clamp_min(0)
            path[t] = torch.where(live, self.bpa[c, t, i], -1)
            idx = torch.where(live, self.bpp[c, t, i].long(), idx)
        return path.cpu().numpy(), int(idx), float(cost[c])

    def records(self, c: int, bd: Optional[dict] = None):
        """Lane c's β-pruned records → the host dict
        ``BeamDecoder.build_compact_lattice`` reads.  ``bd`` receives the
        device pass and fetch times (ms) and the record count."""
        dec = self.dec
        T = int(self.frames[c])
        t0 = time.perf_counter()
        sl = slice(c, c + 1)
        kept, counts = dec._beta_pass(
            self.chunks[sl, :T], self.alphas[sl, :T],
            self.all_active[sl, None].expand(1, T),
            self.tok[0][sl], self.tok[1][sl])
        n = int(counts.sum())
        t1 = time.perf_counter()
        host = {
            "rec_counts": counts[0].cpu().numpy(),
            "rec_packed": dec._compact(kept, counts, True, n).cpu().numpy(),
            "tok_final": self.best()[0][c].cpu().numpy(),
            "rec_reversed": 1,
        }
        if bd is not None:
            bd["device_ms"] = (t1 - t0) * 1e3
            bd["record_fetch_ms"] = (time.perf_counter() - t1) * 1e3
            bd["n_records"] = n
        return host


def _scores_on(loglikes, device: torch.device) -> torch.Tensor:
    """A (t, P) score chunk (numpy or tensor) as float32 on ``device``
    (no copy when it is already there)."""
    return torch.as_tensor(loglikes, dtype=torch.float32, device=device)


def _path_olabels(dec: BeamDecoder, path: np.ndarray, slot0: int
                  ) -> List[int]:
    """The winning arc-index path → plain word olabels (sequence-encoded
    arcs expanded, the initial token's start-closure olabel first).  A
    path that ends before frame 0 is a broken backpointer chain."""
    if slot0 < 0:
        raise KaldiError("streaming decode: broken backpointer chain")
    aidx = path[path >= 0]
    ols = list(dec._expand_ol(int(dec._init_ols[slot0])))
    for o in dec._flat[aidx, 4]:
        if o:
            ols.extend(dec._expand_ol(int(o)))
    return ols


def _tids(dec: BeamDecoder, path: np.ndarray) -> List[int]:
    aidx = path[path >= 0]
    return [int(t) for t in dec._flat[aidx, 2] if t]


class OnlineBeamDecoder:
    """Chunked decoding over a BeamDecoder's graph, on its device.

    Usage::

        ob = OnlineBeamDecoder(dec, chunk_frames=32)
        ob.reset()
        for scores_chunk in stream:       # (t, num_pdfs) pieces
            ob.advance(scores_chunk)
            words, cost = ob.partial()    # any time
        clat = ob.finalize()              # determinized CompactLattice

    ``advance`` runs a chunk step for every ``chunk_frames`` frames it
    has and keeps the rest until the next call; ``partial``,
    ``get_best_path`` and ``finalize`` run the frames kept.  Set ``tm``
    and ``silence_phones`` for ``trailing_silence_frames``."""

    def __init__(self, dec: BeamDecoder, chunk_frames: int = 32,
                 max_frames: int = 2048):
        self.dec = dec
        self.C = chunk_frames
        self.tm = None
        self.silence_phones = set()
        self._st = _Streams(dec, 1, max_frames)
        self.reset()

    def reset(self) -> None:
        self._st.reset(0)
        self._ll_parts: List[torch.Tensor] = []
        self._pending: Optional[torch.Tensor] = None

    @property
    def _frames(self) -> int:
        return int(self._st.frames[0])

    @property
    def _deficit(self) -> torch.Tensor:
        return self._st.deficit[0]

    def advance(self, loglikes) -> None:
        """Consume a (t, num_pdfs) score chunk (any t ≥ 0).  Device work
        only when the chunk is already on the decoder's device."""
        ll = _scores_on(loglikes, self.dec.device)
        self._ll_parts.append(ll)
        buf = ll if self._pending is None else torch.cat([self._pending, ll])
        while buf.shape[0] >= self.C:
            self._st.step(buf[None, :self.C], np.array([self.C]))
            buf = buf[self.C:]
        self._pending = buf

    def _flush(self) -> None:
        if self._pending is not None and self._pending.shape[0]:
            self._st.step(self._pending[None],
                          np.array([self._pending.shape[0]]))
            self._pending = self._pending[:0]

    @property
    def num_frames_decoded(self) -> int:
        return self._frames + (0 if self._pending is None
                               else self._pending.shape[0])

    def partial(self) -> Tuple[List[int], float]:
        """(olabel sequence so far, best cost): BestPathEnd +
        TraceBackBestPath at the current frame."""
        self._flush()
        if self._frames == 0:
            return [], 0.0
        path, slot0, cost = self._st.traceback(0)
        return _path_olabels(self.dec, path, slot0), cost

    def partial_tids(self) -> List[int]:
        """tid alignment of the current best path (silence-weighting /
        endpointing input)."""
        self._flush()
        if self._frames == 0:
            return []
        return _tids(self.dec, self._st.traceback(0)[0])

    def finalize(self, max_states: int = 200000):
        """Determinized CompactLattice over everything consumed (the
        GetLattice(final=true) contract).  When the BeamDecoder's
        escalation policy is armed and the stream's beam deficit fired
        it, the whole utterance is re-decoded offline at the escalated
        budget from the kept log-likelihoods.  ``last_finalize_breakdown``
        has the parts' times in ms."""
        self._flush()
        if self._frames == 0:
            raise KaldiError("OnlineBeamDecoder: no frames decoded")
        dec = self.dec
        bd = self.last_finalize_breakdown = {}
        if dec.deficit_fires(float(self._deficit)):
            t0 = time.perf_counter()
            ll = torch.cat(self._ll_parts)[:self._frames].cpu().numpy()
            out = dec._escalator().decode_compact(
                ll, bucket=self.C, max_states=max_states)
            bd["escalated_redecode_ms"] = (time.perf_counter() - t0) * 1e3
            return out
        host = self._st.records(0, bd)
        t1 = time.perf_counter()
        ll = torch.cat(self._ll_parts).cpu().numpy()
        t2 = time.perf_counter()
        bd["record_fetch_ms"] += (t2 - t1) * 1e3
        out = dec.build_compact_lattice(host, self._frames, ll,
                                        max_states=max_states)
        bd["build_determinize_ms"] = (time.perf_counter() - t2) * 1e3
        return out

    # -- SingleUtteranceNnet3Decoder-compatible surface -------------------

    def advance_decoding(self, loglikes) -> None:
        self.advance(loglikes)

    def get_best_path(self, use_final_probs: bool = True
                      ) -> Tuple[List[int], List[int], float]:
        """(tids, olabels, cost) of the current best path."""
        self._flush()
        if self._frames == 0:
            raise KaldiError("OnlineBeamDecoder: no frames decoded")
        path, slot0, cost = self._st.traceback(0)
        return (_tids(self.dec, path), _path_olabels(self.dec, path, slot0),
                cost)

    # Copied from kaldi_tpu/decoder/online_beam.py
    # OnlineBeamDecoder.trailing_silence_frames.
    def trailing_silence_frames(self, tm=None, silence_phones=()) -> int:
        tm = tm or self.tm
        silence_phones = set(silence_phones) or self.silence_phones
        if tm is None or not silence_phones:
            return 0
        n = 0
        for tid in reversed(self.partial_tids()):
            if tm.transition_id_to_phone(tid) in silence_phones:
                n += 1
            else:
                break
        return n

    def endpoint_detected(self, rules=None, frame_shift: float = 0.03,
                          tm=None, silence_phones=()) -> bool:
        """online-endpoint.h EndpointDetected over the current tokens
        (frame_shift defaults to the chain ×3-subsampled rate)."""
        from kaldi_tpu_torch.decoder.online import default_endpoint_rules
        self._flush()
        if self._frames == 0:
            return False
        rules = rules or default_endpoint_rules()
        utt_len = self._frames * frame_shift
        trailing = self.trailing_silence_frames(tm, silence_phones) \
            * frame_shift
        contains_nonsil = trailing < utt_len
        fs = self._st.tok[0][0].cpu().numpy()
        fc = self._st.tok[1][0].cpu().numpy()
        fin = self.dec._g_host["final"][np.maximum(fs, 0)]
        total = np.where(fs >= 0, fc + fin, np.inf)
        best_any = float(np.min(np.where(fs >= 0, fc, np.inf)))
        best_final = float(np.min(total))
        relative_cost = (best_final - best_any
                         if np.isfinite(best_final) else 1e10)
        for r in rules:
            if r.must_contain_nonsilence and not contains_nonsil:
                continue
            if trailing < r.min_trailing_silence:
                continue
            if relative_cost > r.max_relative_cost:
                continue
            if utt_len < r.min_utterance_length:
                continue
            return True
        return False


class MultiStreamBeamDecoder:
    """N concurrent streaming channels on one device (the CudaDecoder
    multi-lane/multi-channel model: LaneCounters/ChannelCounters in
    cuda-decoder.h).  One batched frame step advances every channel; an
    idle channel rides along with no frames and keeps its tokens,
    buffers and deficit as they were.  Channels are reset and finalized
    one by one, so utterances of different lengths stream through the
    same lanes back to back."""

    def __init__(self, dec: BeamDecoder, n_channels: int = 8,
                 chunk_frames: int = 32, max_frames: int = 2048):
        self.dec = dec
        self.N = n_channels
        self.C = chunk_frames
        self._st = _Streams(dec, n_channels, max_frames)
        self._ll: List[List[torch.Tensor]] = [[] for _ in range(n_channels)]

    @property
    def _deficit(self) -> torch.Tensor:
        return self._st.deficit

    def reset_channel(self, c: int) -> None:
        self._st.reset(c)
        self._ll[c] = []

    def advance(self, chunks: Sequence) -> None:
        """chunks[c] = (t ≤ chunk_frames, P) scores for channel c, or
        None for an idle channel: one batched chunk step."""
        if len(chunks) != self.N:
            raise KaldiError(f"advance: {len(chunks)} chunks for {self.N} "
                             "channels")
        dev = self.dec.device
        X = torch.zeros((self.N, self.C, self.dec.num_pdfs), device=dev)
        nv = np.zeros(self.N, np.int64)
        for c, ch in enumerate(chunks):
            if ch is None or len(ch) == 0:
                continue
            if len(ch) > self.C:
                raise KaldiError("advance: chunk longer than chunk_frames")
            ch = _scores_on(ch, dev)
            X[c, :ch.shape[0]] = ch
            nv[c] = ch.shape[0]
            self._ll[c].append(ch)
        self._st.step(X, nv)

    def finalize_channel(self, c: int, max_states: int = 200000):
        """Determinized CompactLattice for channel c (then
        reset_channel(c) to reuse the lane)."""
        dec = self.dec
        T = int(self._st.frames[c])
        if T == 0:
            raise KaldiError("finalize_channel: no frames decoded")
        ll = torch.cat(self._ll[c]).cpu().numpy()
        if dec.deficit_fires(float(self._st.deficit[c])):
            return dec._escalator().decode_compact(
                ll[:T], bucket=self.C, max_states=max_states)
        return dec.build_compact_lattice(self._st.records(c), T, ll,
                                         max_states=max_states)
