"""Port of kaldi_tpu/cli/tools_bank22.py gmm-acc-stats-twofeats (parity
target gmmbin/gmm-acc-stats-twofeats.cc, the SAT alignment-model stage of
steps/train_sat.sh) and gmm-decode-simple (gmmbin/gmm-decode-simple.cc),
registered in cli/tools.py's ``TOOLS``.  Both take ``--device`` (default
cuda).  gmm-acc-stats-twofeats computes the mixture posteriors on the
first feature stream there (am/gmm.py ``accumulate_stats_twofeats``),
the statistics on the second are summed on the host, as in the
original.  gmm-decode-simple computes the GMM log-likelihoods there and
runs the unpruned host Viterbi (decoder/simple.py).
gmm-decode-faster-regtree-fmllr, gmm-decode-faster-regtree-mllr,
gmm-est-regtree-fmllr-ali and gmm-latgen-map (gmmbin/, the same names)
take ``--device`` too: the speaker's transform, the GMM kernel and the
decoder (gmm-latgen-map: the MAP statistics' posteriors and each
speaker's adapted model) run there; the regression tree and the
estimates are host numpy (am/regtree.py).
"""

from __future__ import annotations

import numpy as np
import torch

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


# Port of kaldi_tpu/cli/tools_bank22.py _regtree_decode.
def _regtree_decode(argv, name: str):
    """Shared body of gmm-decode-faster-regtree-{fmllr,mllr}: apply
    the per-speaker regression-tree transform (root transform as
    written by gmm-est-regtree-*) to features, then decode: the
    transform, the GMM kernel and the dense decoder on ``--device``."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import apply_transform
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions(f"{name} [opts] <model> <fst> "
                      "<transforms-rspec> <feats-rspec> <words-wspec>")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("utt2spk", str, "", "utterance→speaker map rspec")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    dec = DenseDecoder(_load_hclg(args[1]), tm.tid_to_pdf_array,
                       DenseDecoderConfig(
                           beam=po["beam"],
                           acoustic_scale=po["acoustic-scale"]),
                       device=device)
    trans = RandomAccessTableReader(args[2], holder="mat")
    utt2spk = {}
    if po["utt2spk"]:
        for u, s in SequentialTableReader(po["utt2spk"], holder="text"):
            utt2spk[u] = s[0]
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    n = 0
    with TableWriter(args[4], holder="text") as w:
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            spk = utt2spk.get(key, key)
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            if spk in trans:
                x = apply_transform(x, np.asarray(trans[spk])).contiguous()
            _tids, ols, _cost = dec.decode(am.loglikes(x))
            w[key] = [words_tab.find(o) if words_tab else str(o)
                      for o in ols]
            n += 1
    log.info("%s: %d utterances; GMM kernel launches %d", name, n,
             am.device_params().launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank22.py gmm_decode_faster_regtree_fmllr_tool.
@tool("gmm-decode-faster-regtree-fmllr")
def gmm_decode_faster_regtree_fmllr_tool(argv):
    """Decode with per-speaker regtree fMLLR transforms
    (gmmbin/gmm-decode-faster-regtree-fmllr.cc)."""
    return _regtree_decode(argv, "gmm-decode-faster-regtree-fmllr")


# Port of kaldi_tpu/cli/tools_bank22.py gmm_decode_faster_regtree_mllr_tool.
@tool("gmm-decode-faster-regtree-mllr")
def gmm_decode_faster_regtree_mllr_tool(argv):
    """Decode with per-speaker regtree MLLR mean transforms, applied
    in feature space via the root transform our gmm-est-regtree-mllr
    writes (gmmbin/gmm-decode-faster-regtree-mllr.cc role)."""
    return _regtree_decode(argv, "gmm-decode-faster-regtree-mllr")


# Copied from kaldi_tpu/cli/tools_bank22.py gmm_est_regtree_fmllr_ali_tool.
@tool("gmm-est-regtree-fmllr-ali")
def gmm_est_regtree_fmllr_ali_tool(argv):
    """Regtree fMLLR from ALIGNMENTS
    (gmmbin/gmm-est-regtree-fmllr-ali.cc; our gmm-est-regtree-fmllr
    already takes alignments — same flow)."""
    from kaldi_tpu_torch.cli.tools_bank17 import gmm_est_regtree_fmllr_tool
    return gmm_est_regtree_fmllr_tool(argv)


# Port of kaldi_tpu/cli/tools_bank22.py gmm_latgen_map_tool.
@tool("gmm-latgen-map")
def gmm_latgen_map_tool(argv):
    """MAP-adapted lattice decoding (gmmbin/gmm-latgen-map.cc): each
    speaker's model is MAP-mean-adapted from its own first-pass
    alignments before decoding.  The statistics' posteriors, each
    speaker's model (its GMM kernel tables built once for the speaker)
    and the decoder run on ``--device``; the decoder is built once (the
    original rebuilt it for every speaker)."""
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs,
                                        accumulate_stats, map_update)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.core.table import TableWriter
    po = ParseOptions("gmm-latgen-map [opts] <model> <fst> "
                      "<feats-rspec> <ali-rspec> <lattice-wspec>")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("mean-tau", float, 10.0, "MAP prior count")
    po.register("utt2spk", str, "", "utterance→speaker map rspec")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    ali_r = RandomAccessTableReader(args[3], holder="ivec")
    utt2spk = {}
    if po["utt2spk"]:
        for u, s in SequentialTableReader(po["utt2spk"], holder="text"):
            utt2spk[u] = s[0]
    feats_all = dict(SequentialTableReader(args[2], holder="mat"))
    spk2utt = {}
    for u in feats_all:
        spk2utt.setdefault(utt2spk.get(u, u), []).append(u)
    dec = _LatgenDecoder(_load_hclg(args[1]), tm.tid_to_pdf_array,
                         po["beam"], po["lattice-beam"],
                         po["acoustic-scale"], device=device)
    n = launches = 0
    with TableWriter(args[4], holder="clat") as w:
        for spk, utts in spk2utt.items():
            # the statistics' posteriors under the unadapted model (the
            # original's fresh copy of it), whose tables serve every
            # speaker
            accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
            got = False
            for u in utts:
                if u in ali_r:
                    tids = np.asarray(ali_r[u], np.int64)
                    accumulate_stats(
                        am, np.asarray(feats_all[u], np.float32),
                        tm.tid_to_pdf_array[tids], accs)
                    got = True
            adapted = am
            if got:
                adapted = AmDiagGmm(am.weights, am.means, am.vars,
                                    device=device)
                map_update(adapted, accs, mean_tau=po["mean-tau"])
            for u in utts:
                w[u] = dec.decode_to_clat(adapted.loglikes(
                    np.asarray(feats_all[u], np.float32)))
                n += 1
            if adapted is not am:
                launches += adapted.device_params().launches
    log.info("gmm-latgen-map: %d utterances, %d speakers; GMM kernel "
             "launches %d", n, len(spk2utt),
             launches + am.device_params().launches)
    return 0
