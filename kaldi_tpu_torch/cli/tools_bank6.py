"""Port of kaldi_tpu/cli/tools_bank6.py gmm-adapt-map (parity target
gmmbin/gmm-adapt-map.cc) and gmm-latgen-biglm-faster (gmmbin/
gmm-latgen-biglm-faster.cc), registered in cli/tools.py's ``TOOLS``.
Both take ``--device`` (default cuda).  gmm-adapt-map accumulates the
aligned frames' statistics there (am/gmm.py ``accumulate_stats``), and
the MAP update is the original's host numpy (``map_update``).
gmm-latgen-biglm-faster computes each utterance's GMM log-likelihoods
there (the GMM kernel on a card) and searches on the host
(decoder/biglm.py, the original's numpy).
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank6.py gmm_adapt_map_tool.
@tool("gmm-adapt-map")
def gmm_adapt_map_tool(argv):
    """MAP mean adaptation of a GMM model to new data.

    Usage: gmm-adapt-map [opts] <model-in> <feats-rspec> <ali-rspec>
           <model-out>"""
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats, map_update
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    po = ParseOptions(
        "gmm-adapt-map [opts] <model-in> <feats-rspec> <ali-rspec> "
        "<model-out>")
    po.register("mean-tau", float, 10.0, "prior count for means")
    po.register("weight-tau", float, 0.0, "prior count for weights "
                "(0 = no weight update)")
    po.register("var-tau", float, 0.0, "prior count for variances "
                "(0 = no variance update)")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    feats = RandomAccessTableReader(args[1], holder="mat")
    accs = GmmAccs.zeros(am.num_pdfs, am.means.shape[1],
                         am.means.shape[2])
    n = 0
    for key, tids in SequentialTableReader(args[2], holder="ivec"):
        if key not in feats:
            continue
        pdfs = tm.tid_to_pdf_array[np.asarray(tids, np.int64)]
        accumulate_stats(am, np.asarray(feats[key]), pdfs, accs)
        n += 1
    map_update(am, accs, mean_tau=po["mean-tau"],
               weight_tau=po["weight-tau"], var_tau=po["var-tau"])
    write_mdl(args[3], tm, am)
    log.info("MAP-adapted on %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank6.py gmm_latgen_biglm_faster_tool.
@tool("gmm-latgen-biglm-faster")
def gmm_latgen_biglm_faster_tool(argv):
    """Decode with on-the-fly big-LM composition (difference LM).

    Usage: gmm-latgen-biglm-faster [opts] <model> <fst> <old-arpa>
           <new-arpa> <feats-rspec> <words-wspec>
    <fst> is the HCLG compiled with the OLD (small) LM; word scores are
    swapped for the new LM's during the search."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.biglm import (BiglmDecoderConfig,
                                               BiglmFasterDecoder)
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions(
        "gmm-latgen-biglm-faster [opts] <model> <fst> <old-arpa> "
        "<new-arpa> <feats-rspec> <words-wspec>")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("max-active", int, 7000, "max active tokens")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt (REQUIRED)")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 6 or not po["word-symbol-table"]:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    HCLG = _load_hclg(args[1])
    old_lm = ArpaModel.parse(args[2])
    new_lm = ArpaModel.parse(args[3])
    words = SymbolTable.read(po["word-symbol-table"])
    dec = BiglmFasterDecoder(
        HCLG, tm.tid_to_pdf_array, old_lm.score, new_lm.score, words,
        BiglmDecoderConfig(beam=po["beam"], max_active=po["max-active"],
                           acoustic_scale=po["acoustic-scale"],
                           history_len=max(new_lm.order - 1, 1)))
    n = 0
    with TableWriter(args[5], holder="text") as w:
        for key, feats in SequentialTableReader(args[4], holder="mat"):
            ll = am.loglikes(np.asarray(feats, np.float32)).cpu().numpy()
            _, ols, cost = dec.decode(ll)
            text = [words.find(o) for o in ols]
            w[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
    log.info("decoded %d utterances with big-LM composition; GMM kernel "
             "launches %d", n, am.device_params().launches)
    return 0
