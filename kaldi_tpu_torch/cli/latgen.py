"""gmm-latgen-faster: GMM lattice decoding from disk artifacts.

Port of ``_load_hclg``, ``register_latgen_opts``, ``latgen_kwargs``,
``_LatgenDecoder`` and the ``gmm-latgen-faster`` tool of
kaldi_tpu/cli/tools.py.  It reads a ``.mdl`` and an ``HCLG.fst`` that
either package wrote and a feature table, computes GMM log-likelihoods
on ``--device`` (the GMM kernel on a CUDA card) and writes determinized
CompactLattices and, optionally, the best-path words, through
``kaldi_tpu_torch.core.table``.  Graphs up to 20,000 states decode with
the dense decoder, larger ones with the beam decoder, as in the
original.

    python -m kaldi_tpu_torch.cli.latgen [opts] <model> <fst> \\
        <feats-rspec> <lattice-wspec> [<words-wspec>]
"""

from __future__ import annotations

import struct
import sys

import torch

from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools.py _load_hclg.
def _load_hclg(path: str):
    """Text or binary OpenFst vector/const file → VectorFst."""
    from kaldi_tpu_torch.fst.fst import VectorFst
    with open(path, "rb") as fh:
        is_binary = fh.read(4) == struct.pack("<i", 2125659606)
    if is_binary:
        from kaldi_tpu_torch.fst.openfst_io import read_fst_path
        return read_fst_path(path)
    return VectorFst.read_text(path)


# Copied from kaldi_tpu/cli/tools.py register_latgen_opts.
def register_latgen_opts(po) -> None:
    """Register the BeamDecoder budget/escalation knobs on a latgen
    tool's ParseOptions."""
    po.register("arc-budget", int, 4096,
                "device arcs expanded per frame (0 = auto-wide)")
    po.register("escalate-budget", int, 16384,
                "re-decode budget for utterances the arc budget "
                "over-pruned (0 disables escalation)")
    po.register("escalate-deficit", float, 4.0,
                "escalation trigger: accumulated beam deficit "
                "(sum over frames of lattice-beam shortfall)")
    po.register("arc-block", int, 8, "arcs fetched per gather row")


# Copied from kaldi_tpu/cli/tools.py latgen_kwargs.
def latgen_kwargs(po) -> dict:
    """po → _LatgenDecoder keyword overrides (after
    register_latgen_opts)."""
    return dict(arc_budget=po["arc-budget"],
                escalate_budget=po["escalate-budget"],
                escalate_deficit=po["escalate-deficit"],
                arc_block=po["arc-block"])


class _LatgenDecoder:
    """Decoder dispatch for the latgen tools, on one device:
    DenseDecoder (gather Viterbi) up to ``dense_limit`` states,
    BeamDecoder (the large-vocab sort decoder with the native lattice
    build + determinize) above it.  Defaults as in the original: the
    arc budget runs at 4096 with demand-triggered escalation to
    16384.  ``HCLG`` is a VectorFst or a CsrGraph; each branch converts
    it to the form its decoder packs (the beam decoder takes a CsrGraph
    as it is)."""

    def __init__(self, HCLG, tid_to_pdf, beam, lattice_beam,
                 acoustic_scale, max_active=7000, dense_limit=20000,
                 arc_budget=4096, escalate_budget=16384,
                 escalate_deficit=4.0, arc_block=8,
                 device: torch.device | str = "cuda"):
        from kaldi_tpu_torch.fst.csr import CsrGraph
        device = resolve_device(device)
        if HCLG.num_states > dense_limit:
            from kaldi_tpu_torch.fst.csr import pack_fst
            from kaldi_tpu_torch.decoder.beam import (BeamDecoder,
                                                      BeamDecoderConfig)
            cap = max(max_active, 512)
            csr = HCLG if isinstance(HCLG, CsrGraph) else pack_fst(HCLG)
            self._dec = BeamDecoder(csr, tid_to_pdf,
                                    BeamDecoderConfig(
                beam=beam, lattice_beam=lattice_beam,
                acoustic_scale=acoustic_scale, max_active=max_active,
                arc_budget=arc_budget, arc_block=arc_block,
                escalate_budget=escalate_budget,
                escalate_deficit=escalate_deficit,
                lattice_arcs_per_frame=max(2 * cap, 4096)), device=device)
            self._compact = True
            log.info("latgen: %d states → BeamDecoder (large-graph "
                     "path; arc_budget %d, escalate %d)",
                     HCLG.num_states, arc_budget, escalate_budget)
        else:
            from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
            from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                                       DenseDecoderConfig)
            if isinstance(HCLG, CsrGraph):
                HCLG = csr_to_vector_fst(HCLG)
            self._dec = DenseDecoder(HCLG, tid_to_pdf, DenseDecoderConfig(
                beam=beam, lattice_beam=lattice_beam,
                acoustic_scale=acoustic_scale), device=device)
            self._compact = False

    def decode_to_clat(self, loglikes):
        """(T, P) log-likelihoods (numpy or tensor) → determinized
        CompactLattice."""
        if self._compact:
            return self._dec.decode_compact(loglikes)
        lat, _best = self._dec.decode_lattice(loglikes)
        return self.determinize(lat)

    def determinize(self, lat):
        """The dense branch's raw Lattice → CompactLattice."""
        from kaldi_tpu_torch.lattice.determinize import \
            determinize_lattice_pruned
        # blowup → prune with halved beams and retry (the
        # DeterminizeLatticePhonePrunedWrapper contract)
        return determinize_lattice_pruned(
            lat, self._dec.config.lattice_beam)


def gmm_latgen_faster(argv=None) -> int:
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions(
        "gmm-latgen-faster [opts] <model> <fst> <feats-rspec> "
        "<lattice-wspec> [<words-wspec>]\n"
        "<fst> may be a text FST or a binary OpenFst vector/const file")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt for text output")
    po.register("device", str, "cuda", "torch device to decode on")
    register_latgen_opts(po)
    args = po.read(argv)
    if len(args) not in (4, 5):
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=po["device"])
    HCLG = _load_hclg(args[1])
    dec = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, po["beam"],
                         po["lattice-beam"], po["acoustic-scale"],
                         max_active=po["max-active"], device=po["device"],
                         **latgen_kwargs(po))
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    wwriter = (TableWriter(args[4], holder="text")
               if len(args) > 4 else None)
    n, tot_frames = 0, 0
    with TableWriter(args[3], holder="clat") as lw:
        for key, feats in SequentialTableReader(args[2], holder="mat"):
            ll = am.loglikes(feats)
            clat = dec.decode_to_clat(ll)
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w) for w in wseq]
            if wwriter:
                wwriter[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
            tot_frames += ll.shape[0]
    if wwriter:
        wwriter.close()
    log.info("decoded %d utterances, %d frames; GMM kernel launches %d", n,
             tot_frames, am.device_params().launches)
    return 0


if __name__ == "__main__":
    sys.exit(gmm_latgen_faster())
