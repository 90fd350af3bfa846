"""Port of kaldi_tpu/cli/tools_bank22.py gmm-acc-stats-twofeats (parity
target gmmbin/gmm-acc-stats-twofeats.cc, the SAT alignment-model stage of
steps/train_sat.sh) and gmm-decode-simple (gmmbin/gmm-decode-simple.cc),
registered in cli/tools.py's ``TOOLS``.  Both take ``--device`` (default
cuda).  gmm-acc-stats-twofeats computes the mixture posteriors on the
first feature stream there (am/gmm.py ``accumulate_stats_twofeats``),
the statistics on the second are summed on the host, as in the
original.  gmm-decode-simple computes the GMM log-likelihoods there and
runs the unpruned host Viterbi (decoder/simple.py).
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


# Port of kaldi_tpu/cli/tools_bank22.py gmm_acc_stats_twofeats_tool.
@tool("gmm-acc-stats-twofeats")
def gmm_acc_stats_twofeats_tool(argv):
    """Posteriors on one feature stream, stats on another
    (gmmbin/gmm-acc-stats-twofeats.cc — the SAT alimdl stage of
    steps/train_sat.sh)."""
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats_twofeats
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_extra import write_gmm_accs
    po = ParseOptions("gmm-acc-stats-twofeats <model> <feats1-rspec> "
                      "<feats2-rspec> <ali-rspec> <accs-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 5:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    f2 = RandomAccessTableReader(args[2], holder="mat")
    ali_r = RandomAccessTableReader(args[3], holder="ivec")
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in f2 or key not in ali_r:
            continue
        tids = np.asarray(ali_r[key], np.int64)
        pdf_ali = tm.tid_to_pdf_array[tids]
        accumulate_stats_twofeats(am, np.asarray(feats, np.float32),
                                  np.asarray(f2[key], np.float32),
                                  pdf_ali, accs)
        n += 1
    write_gmm_accs(args[4], accs)
    log.info("gmm-acc-stats-twofeats: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank22.py gmm_decode_simple_tool.
@tool("gmm-decode-simple")
def gmm_decode_simple_tool(argv):
    """Unpruned reference decode (gmmbin/gmm-decode-simple.cc,
    SimpleDecoder — the oracle decoders are validated against)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.simple import SimpleDecoder
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("gmm-decode-simple [opts] <model> <fst> "
                      "<feats-rspec> <words-wspec> [<ali-wspec>]")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    fst_obj = _load_hclg(args[1])
    dec = SimpleDecoder(fst_obj, acoustic_scale=po["acoustic-scale"])
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    awriter = (TableWriter(args[4], holder="ivec")
               if len(args) > 4 else None)
    n = 0
    with TableWriter(args[3], holder="text") as w:
        for key, feats in SequentialTableReader(args[2], holder="mat"):
            ll = am.loglikes(np.asarray(feats, np.float32)).cpu().numpy()
            tids, ols, _cost = dec.decode(ll, tm.tid_to_pdf_array)
            w[key] = [words_tab.find(o) if words_tab else str(o)
                      for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("gmm-decode-simple: %d utterances; GMM kernel launches %d", n,
             am.device_params().launches)
    return 0
