"""Port of kaldi_tpu/cli/tools_bank28.py compute-atwv and
chain-make-den-fst (parity targets kwsbin/compute-atwv.cc,
chainbin/chain-make-den-fst.cc), registered in cli/tools.py's
``TOOLS``: host code, copied.  latgen-incremental-mapped
(bin/latgen-incremental-mapped.cc) takes ``--device`` (default cuda):
``OnlineBeamDecoder`` advances over the log-likelihood matrices there.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader

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
    import numpy as np
    import torch
    from kaldi_tpu_torch.cli.tools import _device_po
    from kaldi_tpu_torch.cli.tools_bank31 import incremental_decoder
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.device import resolve_device
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
