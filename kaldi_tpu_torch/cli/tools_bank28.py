"""Port of kaldi_tpu/cli/tools_bank28.py compute-atwv and
chain-make-den-fst (parity targets kwsbin/compute-atwv.cc,
chainbin/chain-make-den-fst.cc), registered in cli/tools.py's
``TOOLS``: host code, copied.  latgen-incremental-mapped
(bin/latgen-incremental-mapped.cc) takes ``--device`` (default cuda):
``OnlineBeamDecoder`` advances over the log-likelihood matrices there.
align-compiled-mapped (bin/align-compiled-mapped.cc) takes ``--device``:
``DenseAligner`` aligns one utterance a call there, as the original
does (``align_compiled``, which align-mapped, nnet3-align-compiled and
nnet-align-compiled share).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank28.py compute_atwv_tool.
@tool("compute-atwv")
def compute_atwv_tool(argv):
    """Actual Term-Weighted Value of keyword-search results
    (kwsbin/compute-atwv.cc): ATWV = 1 − mean_kw[Pmiss + β·PFA] with
    β = trials-per-second scaling; hits match references when their
    frame midpoint falls inside the reference span (±tolerance)."""
    po = ParseOptions("compute-atwv <total-audio-frames> <ref-rspec> "
                      "<hits-rspec>\nboth tables use the kws-search "
                      "hit format: key '<kw>-<n>', value "
                      "'<utt> <t-begin> <t-end> [<score>]'")
    po.register("beta", float, 999.9, "false-alarm weight")
    po.register("frame-tolerance", int, 50,
                "midpoint tolerance (frames)")
    po.register("print-per-keyword", bool, False,
                "log per-keyword TWV terms")
    args = po.read(argv)
    T_total = float(args[0])

    def load(rspec):
        table: Dict[str, List[Tuple[str, int, int]]] = {}
        for key, toks in SequentialTableReader(rspec, holder="text"):
            kw = key.rsplit("-", 1)[0]
            toks = list(toks)
            table.setdefault(kw, []).append(
                (toks[0], int(toks[1]), int(toks[2])))
        return table

    refs = load(args[1])
    hyps = load(args[2])
    if not refs:
        raise KaldiError("compute-atwv: empty reference")
    beta = po["beta"]
    tol = po["frame-tolerance"]
    twv_sum = 0.0
    for kw, ref_list in sorted(refs.items()):
        n_true = len(ref_list)
        hyp_list = hyps.get(kw, [])
        used = [False] * len(ref_list)
        n_hit = n_fa = 0
        for utt, tb, te in hyp_list:
            mid = (tb + te) / 2
            matched = False
            for i, (rutt, rtb, rte) in enumerate(ref_list):
                if used[i] or rutt != utt:
                    continue
                if rtb - tol <= mid <= rte + tol:
                    used[i] = True
                    matched = True
                    break
            if matched:
                n_hit += 1
            else:
                n_fa += 1
        p_miss = 1.0 - n_hit / n_true
        denom = max(T_total / 100.0 - n_true, 1.0)   # trials ≈ seconds
        p_fa = n_fa / denom
        twv = 1.0 - p_miss - beta * p_fa
        twv_sum += twv
        if po["print-per-keyword"]:
            log.info("compute-atwv: kw %s: hit %d/%d, fa %d, "
                     "twv %.4f", kw, n_hit, n_true, n_fa, twv)
    atwv = twv_sum / len(refs)
    print(f"{atwv:.4f}")
    log.info("compute-atwv: ATWV %.4f over %d keywords", atwv,
             len(refs))
    return 0


# Copied from kaldi_tpu/cli/tools_bank28.py chain_make_den_fst_tool.
@tool("chain-make-den-fst")
def chain_make_den_fst_tool(argv):
    """Denominator graph from training phone sequences — the upstream
    chainbin spelling (chainbin/chain-make-den-fst.cc); same flow as
    nnet3-chain-make-den-fst."""
    from kaldi_tpu_torch.cli.tools_bank16 import nnet3_chain_make_den_fst_tool
    return nnet3_chain_make_den_fst_tool(argv)


# Port of kaldi_tpu/cli/tools_bank28.py latgen_incremental_mapped_tool.
@tool("latgen-incremental-mapped")
def latgen_incremental_mapped_tool(argv):
    """Lattice decoding from loglike matrices with CHUNKED advance and
    bounded in-flight state (bin/latgen-incremental-mapped.cc role):
    the online beam decoder consumes --chunk-frames at a time and the
    lattice is finalized incrementally, so peak memory is bounded by
    the chunk, not the utterance."""
    import torch
    from kaldi_tpu_torch.cli.tools_bank31 import incremental_decoder
    po = ParseOptions("latgen-incremental-mapped [opts] <trans-model> "
                      "<fst> <loglikes-rspec> <lattice-wspec>")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("chunk-frames", int, 32, "frames per advance")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, ob = incremental_decoder(args[0], args[1], po, device,
                                  chunk_frames=po["chunk-frames"])
    C = po["chunk-frames"]
    n = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, ll in SequentialTableReader(args[2], holder="mat"):
            ll = torch.as_tensor(np.asarray(ll, np.float32)).to(device)
            ob.reset()
            for c in range(0, len(ll), C):
                ob.advance(ll[c:c + C])
            w[key] = ob.finalize()
            n += 1
    log.info("latgen-incremental-mapped: %d utterances "
             "(chunk %d)", n, C)
    return 0


def align_compiled(name: str, tid_to_pdf: np.ndarray, graphs_rspec: str,
                   scored, ali_wspec: str, acoustic_scale: float,
                   device) -> int:
    """The forced alignment of the original's mapped aligners: every
    graph of ``graphs_rspec`` padded to the table's largest
    (``pack_dense_reverse``), then one ``DenseAligner.align_batch`` call
    an utterance on ``device`` over the (T, P) log-likelihoods that
    ``scored`` yields as (key, matrix or tensor); the transition-id
    alignments go to ``ali_wspec``.  → the number aligned."""
    from kaldi_tpu_torch.decoder.align import (DenseAligner, in_degrees,
                                               pack_dense_reverse)
    graphs = dict(SequentialTableReader(graphs_rspec, holder="fst"))
    aligner = DenseAligner(tid_to_pdf, acoustic_scale=acoustic_scale,
                           device=device)
    ae = an = smax = 1
    for g in graphs.values():
        e, nn = in_degrees(g)
        ae, an = max(ae, e), max(an, nn)
        smax = max(smax, g.num_states)
    n = 0
    with TableWriter(ali_wspec, holder="ivec") as w:
        for key, ll in scored:
            if key not in graphs:
                log.warning("%s: no graph for %s", name, key)
                continue
            g = pack_dense_reverse(graphs[key], smax, ae, an)
            (tids, _cost), = aligner.align_batch([g], [ll])
            w[key] = np.asarray(tids, np.int32)
            n += 1
    log.info("%s: aligned %d utterances", name, n)
    return n


def mapped_loglikes(rspec: str):
    """(key, float32 matrix) of a log-likelihood table."""
    for key, ll in SequentialTableReader(rspec, holder="mat"):
        yield key, np.asarray(ll, np.float32)


# Port of kaldi_tpu/cli/tools_bank28.py align_compiled_mapped_tool.
@tool("align-compiled-mapped")
def align_compiled_mapped_tool(argv):
    """Forced alignment from precomputed loglike matrices over
    compiled graphs on ``--device`` (bin/align-compiled-mapped.cc; rows
    are pdf loglikes, the transition model supplies tid→pdf)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions("align-compiled-mapped [opts] <trans-model> "
                      "<graphs-rspec> <loglikes-rspec> <ali-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    align_compiled("align-compiled-mapped", tm.tid_to_pdf_array, args[1],
                   mapped_loglikes(args[2]), args[3], po["acoustic-scale"],
                   device)
    return 0
