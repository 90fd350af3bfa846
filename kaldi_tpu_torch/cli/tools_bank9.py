"""Port of kaldi_tpu/cli/tools_bank9.py convert-ali, gmm-decode-faster,
acc-lda, est-lda, gmm-acc-mllt and est-mllt (parity targets
bin/convert-ali.cc, gmmbin/gmm-decode-faster.cc, bin/acc-lda.cc,
est-lda.cc, gmmbin/gmm-acc-mllt.cc, bin/est-mllt.cc), registered in
cli/tools.py's ``TOOLS``.  gmm-decode-faster takes ``--device`` (default
cuda): the GMM log-likelihoods (the GMM kernel on a card) and the dense
decoder's Viterbi run there.

convert-ali, the LDA statistics and both estimators are the original's
host numpy, copied, and take no ``--device``.  gmm-acc-mllt takes
``--device`` (default cuda): each utterance's mixture posteriors come
from ``AmDiagGmm.component_posteriors`` there, and the MLLT statistics
are summed in float64 on the host, as in the original.  The accumulator
files are the original's, byte for byte.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank9.py convert_ali.
@tool("convert-ali")
def convert_ali(argv):
    """Remap tid alignments onto a new model/tree (bin/convert-ali.cc:
    same phone sequence and HMM-state path, new pdf-ids)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.pipelines.tri import convert_alignment
    po = ParseOptions("convert-ali <old-model> <new-model> <new-tree:"
                      "unused, tree travels inside the .mdl> "
                      "<ali-rspec> <ali-wspec>")
    args = po.read(argv)
    if len(args) == 5:          # kaldi arity (tree arg accepted, unused)
        old_mdl, new_mdl, _tree, rspec, wspec = args
    else:
        old_mdl, new_mdl, rspec, wspec = args
    tm_old, _ = read_mdl(old_mdl, device="cpu")
    tm_new, _ = read_mdl(new_mdl, device="cpu")
    cw = tm_new.tree.context_width
    cp = tm_new.tree.central_position
    n = 0
    with TableWriter(wspec, holder="ivec") as w:
        for key, ali in SequentialTableReader(rspec, holder="ivec"):
            w[key] = np.asarray(
                convert_alignment(tm_old, tm_new, ali.tolist(),
                                  context_width=cw, central_position=cp),
                np.int32)
            n += 1
    log.info("convert-ali: converted %d alignments", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank9.py gmm_decode_faster.
@tool("gmm-decode-faster")
def gmm_decode_faster(argv):
    """Best-path GMM decoding, words + alignment out (no lattice)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    po = ParseOptions("gmm-decode-faster [opts] <model> <fst> "
                      "<feats-rspec> <words-wspec> [<ali-wspec>]")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    fst = _load_hclg(args[1])
    dec = DenseDecoder(fst, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=po["beam"],
                                          acoustic_scale=po["acoustic-scale"]),
                       device=device)
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    awriter = (TableWriter(args[4], holder="ivec")
               if len(args) > 4 else None)
    n = 0
    with TableWriter(args[3], holder="text") as ww:
        for key, feats in SequentialTableReader(args[2], holder="mat"):
            tids, ols, cost = dec.decode(
                am.loglikes(np.asarray(feats, np.float32)))
            ww[key] = [words_tab.find(o) if words_tab else str(o)
                       for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("gmm-decode-faster: decoded %d utterances; GMM kernel "
             "launches %d", n, am.device_params().launches)
    return 0


# Copied from kaldi_tpu/cli/tools_bank9.py: the <LDAACCS> file.
def write_lda_accs(path: str, counts, first, second) -> None:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<LDAACCS>")
        kio.write_matrix(f, counts[None, :])
        kio.write_matrix(f, first)
        kio.write_matrix(f, second)
        kio.write_token(f, "</LDAACCS>")


# Copied from kaldi_tpu/cli/tools_bank9.py: the <LDAACCS> file.
def read_lda_accs(path: str):
    """→ (counts, first, second)."""
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not binary kaldi")
        kio.expect_token(f, "<LDAACCS>")
        counts = kio.read_matrix(f)[0]
        first = kio.read_matrix(f)
        second = kio.read_matrix(f)
        kio.expect_token(f, "</LDAACCS>")
    return counts, first, second


# Copied from kaldi_tpu/cli/tools_bank9.py acc_lda.
@tool("acc-lda")
def acc_lda(argv):
    """Accumulate LDA stats from pdf posteriors (bin/acc-lda.cc).
    Stats file: token-framed counts / first / second."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    po = ParseOptions("acc-lda [opts] <trans-model> <feats-rspec> "
                      "<post-rspec> <acc-out>")
    po.register("rand-prune", float, 0.0, "posterior pruning floor")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    posts = RandomAccessTableReader(args[2], holder="post")
    lda = None
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in posts:
            continue
        feats = np.asarray(feats)
        if lda is None:
            lda = LdaEstimate(tm.num_pdfs, feats.shape[1])
        for t, frame in enumerate(posts[key]):
            for tid, wgt in frame:
                if wgt <= po["rand-prune"]:
                    continue
                lda.accumulate(feats[t], tm.transition_id_to_pdf(int(tid)),
                               float(wgt))
        n += 1
    if lda is None:
        raise KaldiError("acc-lda: no utterances accumulated")
    write_lda_accs(args[3], lda.counts, lda.first, lda.total_second)
    log.info("acc-lda: accumulated %d utterances", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank9.py est_lda.
@tool("est-lda")
def est_lda(argv):
    """Estimate the LDA transform from acc-lda stats (bin/est-lda.cc)."""
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("est-lda [opts] <lda-out> <acc1> [<acc2> ...]")
    po.register("dim", int, 40, "output feature dim")
    po.register("write-full-matrix", str, "",
                "also write the FULL (square) LDA matrix — consumed "
                "by get-full-lda-mat for raw-space fMLLR")
    args = po.read(argv)
    lda = None
    for acc in args[1:]:
        counts, first, second = read_lda_accs(acc)
        if lda is None:
            lda = LdaEstimate(len(counts), first.shape[1])
        lda.counts += counts
        lda.first += first
        lda.total_second += second
    mat = lda.estimate(po["dim"])
    with kio.open_wxfilename(args[0]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, mat)
    if po["write-full-matrix"]:
        full_dim = lda.first.shape[1]
        full = lda.estimate(full_dim)
        with kio.open_wxfilename(po["write-full-matrix"]) as f:
            kio.init_kaldi_output_stream(f)
            kio.write_matrix(f, full)
    log.info("est-lda: wrote %dx%d transform", *mat.shape)
    return 0


# Port of kaldi_tpu/cli/tools_bank9.py gmm_acc_mllt.
@tool("gmm-acc-mllt")
def gmm_acc_mllt(argv):
    """Accumulate MLLT stats from aligned GMMs (bin/gmm-acc-mllt.cc): the
    mixture posteriors on ``--device``, the sums on the host."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import MlltAccs
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("gmm-acc-mllt [opts] <model> <feats-rspec> "
                      "<ali-rspec> <acc-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    alis = RandomAccessTableReader(args[2], holder="ivec")
    accs = None
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in alis:
            continue
        feats = np.asarray(feats)
        if accs is None:
            accs = MlltAccs(feats.shape[1])
        pdfs = tm.tid_to_pdf_array[np.asarray(alis[key], np.int64)]
        post = am.component_posteriors(feats, pdfs).cpu().numpy()
        accs.accumulate(post, feats, am.means[pdfs], 1.0 / am.vars[pdfs])
        n += 1
    if accs is None:
        raise KaldiError("gmm-acc-mllt: no utterances accumulated")
    with kio.open_wxfilename(args[3]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<MLLTACCS>")
        kio.write_basic_float(f, accs.beta)
        for i in range(accs.G.shape[0]):
            kio.write_matrix(f, accs.G[i])
        kio.write_token(f, "</MLLTACCS>")
    log.info("gmm-acc-mllt: accumulated %d utterances", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank9.py est_mllt.
@tool("est-mllt")
def est_mllt(argv):
    """Estimate the MLLT/STC transform (bin/est-mllt.cc)."""
    from kaldi_tpu_torch.am.transforms import MlltAccs
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("est-mllt <mllt-out> <acc1> [<acc2> ...]")
    args = po.read(argv)
    accs = None
    for acc in args[1:]:
        with kio.open_rxfilename(acc) as f:
            if not kio.init_kaldi_input_stream(f):
                raise KaldiError(f"{acc}: not binary kaldi")
            kio.expect_token(f, "<MLLTACCS>")
            beta = kio.read_basic_float(f)
            G0 = kio.read_matrix(f)
            D = G0.shape[0]
            G = np.empty((D, D, D))
            G[0] = G0
            for i in range(1, D):
                G[i] = kio.read_matrix(f)
            kio.expect_token(f, "</MLLTACCS>")
        if accs is None:
            accs = MlltAccs(D)
        accs.beta += beta
        accs.G += G
    mat, impr = accs.update()
    with kio.open_wxfilename(args[0]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, mat)
    log.info("est-mllt: objf impr %.4f/frame", impr)
    return 0
