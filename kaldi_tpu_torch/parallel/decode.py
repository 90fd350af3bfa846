"""Sharded batched decoding over a mesh of ranks.

Port of kaldi_tpu/parallel/decode.py (parity target: steps/decode.sh
--nj N fanning out processes over data splits, and BASELINE.json config
5, the multi-host pod decode).  The original shards the utterance batch
over the mesh's 'data' axis inside one jit.  Here each rank decodes its
contiguous block of rows on its own card with the port's decoders: the
graph is packed and uploaded by every rank (the original's replicated
graph), the per-utterance beams are independent, and no collective runs
in the steady state.  ``decode_batch`` / ``decode_compact_batch`` take the
global batch on every rank and gather every rank's results
(``all_gather_object``) so that each returns all of them in order;
``decode_compact_local`` is the pod path: each rank passes and gets back
only its own rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.decoder.beam import BeamDecoder
from kaldi_tpu_torch.decoder.dense import DenseDecoder
from kaldi_tpu_torch.parallel.mesh import Mesh, batch_sharding


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pad_rows(X: np.ndarray, lens: np.ndarray, ndata: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """B padded up to a multiple of ``ndata`` with one-frame zero rows, as
    the original pads."""
    pad_b = (-X.shape[0]) % ndata
    if pad_b:
        X = np.concatenate([X, np.zeros((pad_b,) + X.shape[1:], X.dtype)])
        lens = np.concatenate([lens, np.ones(pad_b, lens.dtype)])
    return X, lens


def _real_rows(rows: slice, B: int) -> int:
    """How many of this rank's ``rows`` are real (not padding)."""
    return max(0, min(rows.stop, B) - rows.start)


class ShardedDecoder:
    """Wraps a DenseDecoder for data-parallel batch decode on a mesh."""

    def __init__(self, decoder: DenseDecoder, mesh: Mesh):
        self.dec = decoder
        self.mesh = mesh

    def decode_batch(self, loglikes_padded, num_frames
                     ) -> List[Tuple[List[int], List[int], float]]:
        """(B, T_pad, P) + (B,), the global batch on every rank → every
        utterance's (tids, olabels, cost), in order, on every rank."""
        X = _host(loglikes_padded).astype(np.float32, copy=False)
        lens = np.asarray(num_frames, np.int64)
        B = X.shape[0]
        X, lens = _pad_rows(X, lens, self.mesh.data)
        rows = batch_sharding(self.mesh, X.shape[0])
        dec = self.dec
        ll = torch.from_numpy(np.ascontiguousarray(X[rows])).to(dec.device)
        nf = torch.from_numpy(lens[rows]).to(dec.device)
        out = {k: v.cpu().numpy()
               for k, v in dec._decode_device(ll, nf).items()}
        local = [dec._backtrace({k: v[b] for k, v in out.items()},
                                int(lens[rows.start + b]))
                 for b in range(_real_rows(rows, B))]
        return [r for part in self.mesh.all_gather_data(local)
                for r in part]


class ShardedBeamDecoder:
    """Data-parallel LARGE-GRAPH lattice decode on a mesh: the utterance
    batch is sharded over 'data', every rank holds the packed arc table
    on its card, and each runs the port's frame loop on its rows alone —
    no collectives in the steady state, the reference's per-process
    decode semantics at pod scale (BASELINE.json config 5).  Escalation
    and the host lattice builds run on the rank that decoded the row."""

    def __init__(self, decoder: BeamDecoder, mesh: Mesh):
        if not isinstance(decoder, BeamDecoder):
            raise TypeError("ShardedBeamDecoder wraps a BeamDecoder")
        self.dec = decoder
        self.mesh = mesh

    def decode_compact_batch(self, loglikes_padded, num_frames,
                             stats: Optional[Dict] = None):
        """(B, T_pad, P), the global batch on every rank → all B
        determinized CompactLattices in order, on every rank.  B is
        padded up to a multiple of the data-axis size; each rank decodes
        its rows, escalates the ones whose deficit trigger fires and
        builds their lattices, then the ranks gather.  ``stats`` receives
        the batch's diagnostics (``BeamDecoder.decode_compact_batch``'s,
        over every rank)."""
        X = self.dec._host_array(loglikes_padded)
        lens = np.asarray(num_frames, np.int64)
        B = X.shape[0]
        X, lens = _pad_rows(X, lens, self.mesh.data)
        rows = batch_sharding(self.mesh, X.shape[0])
        X_l, lens_l = X[rows], lens[rows]
        hosts = self.dec._decode_host(X_l, lens_l, lattice=True)
        st = {} if stats is not None else None
        lats = self.dec.compact_lattices(hosts[:_real_rows(rows, B)], X_l,
                                         lens_l, stats=st)
        parts = self.mesh.all_gather_data((lats, st))
        if stats is not None:
            _merge_stats(stats, [s for _, s in parts])
        return [lat for part, _ in parts for lat in part]

    def decode_compact_local(self, X_local, lens_local,
                             stats: Optional[Dict] = None):
        """The pod entry: each rank passes ITS rows of the utterance batch
        and gets back lattices for exactly those rows, decoded, escalated
        and built on this rank (the steps/decode.sh --nj split over
        hosts).  No collective: ranks may pass different row counts."""
        return self.dec.decode_compact_batch(X_local, lens_local,
                                             stats=stats)


def _merge_stats(stats: Dict, parts: List[Dict]) -> None:
    """Every rank's diagnostics into ``stats``: least effective beam,
    summed escalations and dropped arcs, the largest peaks."""
    for s in parts:
        for k, v in s.items():
            if k == "min_eff_beam":
                stats[k] = min(stats.get(k, float("inf")), v)
            elif k in ("n_escalated", "dropped_arcs"):
                stats[k] = stats.get(k, 0) + v
            else:
                stats[k] = max(stats.get(k, 0), v)
