"""Port of kaldi_tpu/cli/tools_bank12.py sum-lda-accs, gmm-acc-stats,
gmm-scale-accs, gmm-ismooth-stats, gmm-est-gaussians-ebw,
gmm-est-weights-ebw and gmm-transform-means (parity targets
bin/sum-lda-accs.cc, gmmbin/gmm-acc-stats.cc, gmm-scale-accs.cc,
gmm-ismooth-stats.cc, gmm-est-gaussians-ebw.cc, gmm-est-weights-ebw.cc,
gmm-transform-means.cc), registered in cli/tools.py's ``TOOLS``.

The accumulator algebra, the EBW updates and the mean transform are the
original's host numpy, copied, and take no ``--device``: they read the
model on the CPU.  gmm-acc-stats takes ``--device`` (default cuda): the
original runs one jitted mixture posterior per (frame, transition-id)
entry, the port one ``AmDiagGmm.component_posteriors`` call over every
entry of an utterance on the device, with the weighted sums in float64
(am/ebw.py ``accumulate_post_stats``).  gmm-make-regtree
(gmmbin/gmm-make-regtree.cc) is host numpy (am/regtree.py).
analyze-counts (bin/analyze-counts.cc) is host code, copied.
"""

from __future__ import annotations

import sys

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.cli.tools_chain import _host_mdl
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank12.py sum_lda_accs_tool.
@tool("sum-lda-accs")
def sum_lda_accs_tool(argv):
    """Sum LDA stats files (bin/sum-lda-accs.cc)."""
    from kaldi_tpu_torch.cli.tools_bank9 import read_lda_accs, write_lda_accs
    po = ParseOptions("sum-lda-accs <acc-out> <acc1> [<acc2> ...]")
    args = po.read(argv)
    counts = first = second = None
    for acc in args[1:]:
        c, fi, se = read_lda_accs(acc)
        if counts is None:
            counts, first, second = c.copy(), fi.copy(), se.copy()
        else:
            counts += c
            first += fi
            second += se
    if counts is None:
        raise KaldiError("sum-lda-accs: no input accs")
    write_lda_accs(args[0], counts, first, second)
    return 0


# Port of kaldi_tpu/cli/tools_bank12.py gmm_acc_stats_tool.
@tool("gmm-acc-stats")
def gmm_acc_stats_tool(argv):
    """Accumulate GMM stats from transition-id posteriors
    (gmmbin/gmm-acc-stats.cc) — the soft-count sibling of
    gmm-acc-stats-ali."""
    from kaldi_tpu_torch.am.ebw import accumulate_post_stats
    from kaldi_tpu_torch.am.gmm import GmmAccs
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_extra import write_gmm_accs
    po = ParseOptions("gmm-acc-stats <model-in> <feats-rspec> "
                      "<post-rspec> <accs-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    posts = RandomAccessTableReader(args[2], holder="post")
    n_utt = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in posts:
            continue
        feats = np.asarray(feats, np.float32)
        post = posts[key]
        ts, pdfs, ws = [], [], []
        for t, frame in enumerate(post[:len(feats)]):
            for tid, wgt in frame:
                ts.append(t)
                pdfs.append(tm.transition_id_to_pdf(int(tid)))
                ws.append(wgt)
        accumulate_post_stats(am, feats, np.asarray(ts, np.int64),
                              np.asarray(pdfs, np.int64),
                              np.asarray(ws, np.float64), accs)
        accs.tot_frames += len(post)
        n_utt += 1
    write_gmm_accs(args[3], accs)
    log.info("gmm-acc-stats: %d utterances, occ %.1f", n_utt,
             accs.occ.sum())
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py gmm_scale_accs_tool.
@tool("gmm-scale-accs")
def gmm_scale_accs_tool(argv):
    """Scale GMM accumulators (gmmbin/gmm-scale-accs.cc)."""
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs, write_gmm_accs
    po = ParseOptions("gmm-scale-accs <scale> <accs-in> <accs-out>")
    args = po.read(argv)
    scale = float(args[0])
    accs = read_gmm_accs(args[1])
    accs.occ *= scale
    accs.mean_acc *= scale
    accs.var_acc *= scale
    accs.tot_like *= scale
    accs.tot_frames *= scale
    write_gmm_accs(args[2], accs)
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py gmm_ismooth_stats_tool.
@tool("gmm-ismooth-stats")
def gmm_ismooth_stats_tool(argv):
    """I-smoothing: interpolate stats toward the model's own expected
    stats (gmmbin/gmm-ismooth-stats.cc), the MMI/MPE regularizer."""
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs, write_gmm_accs
    po = ParseOptions("gmm-ismooth-stats [--tau=100] <model-in> "
                      "<accs-in> <accs-out>")
    po.register("tau", float, 100.0, "smoothing count per Gaussian")
    args = po.read(argv)
    _tm, am = _host_mdl(args[0])
    accs = read_gmm_accs(args[1])
    tau = po["tau"]
    valid = am.weights > 0
    accs.occ += tau * valid
    accs.mean_acc += tau * valid[..., None] * am.means
    accs.var_acc += tau * valid[..., None] * (am.vars + am.means ** 2)
    write_gmm_accs(args[2], accs)
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py gmm_est_gaussians_ebw_tool.
@tool("gmm-est-gaussians-ebw")
def gmm_est_gaussians_ebw_tool(argv):
    """EBW mean/variance update from num/den stats
    (gmmbin/gmm-est-gaussians-ebw.cc)."""
    from kaldi_tpu_torch.am.ebw import ebw_update
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    po = ParseOptions("gmm-est-gaussians-ebw [--e=2.0] <model-in> "
                      "<num-accs> <den-accs> <model-out>")
    po.register("e", float, 2.0, "EBW constant E")
    args = po.read(argv)
    tm, am = _host_mdl(args[0])
    num = read_gmm_accs(args[1])
    den = read_gmm_accs(args[2])
    ebw_update(am, num, den, E=po["e"])
    write_mdl(args[3], tm, am)
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py gmm_est_weights_ebw_tool.
@tool("gmm-est-weights-ebw")
def gmm_est_weights_ebw_tool(argv):
    """EBW mixture-weight update (gmmbin/gmm-est-weights-ebw.cc):
    w ∝ γ_num − γ_den + C·w_old with C large enough to keep all
    weights positive, renormalized per pdf."""
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    po = ParseOptions("gmm-est-weights-ebw <model-in> <num-accs> "
                      "<den-accs> <model-out>")
    args = po.read(argv)
    tm, am = _host_mdl(args[0])
    num = read_gmm_accs(args[1])
    den = read_gmm_accs(args[2])
    valid = am.weights > 0
    diff = num.occ - den.occ
    # per-pdf smoothing constant keeping every valid weight positive
    with np.errstate(divide="ignore", invalid="ignore"):
        need = np.where(valid, -diff / np.maximum(am.weights, 1e-10), 0.0)
    C = np.maximum(need.max(axis=1, keepdims=True) * 1.1, 1.0)
    neww = np.where(valid, diff + C * am.weights, 0.0)
    neww = np.maximum(neww, 0.0)
    tot = neww.sum(axis=1, keepdims=True)
    ok = tot[:, 0] > 0
    am.weights[ok] = neww[ok] / tot[ok]
    am.refresh()
    write_mdl(args[3], tm, am)
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py gmm_transform_means_tool.
@tool("gmm-transform-means")
def gmm_transform_means_tool(argv):
    """Apply a (D×D or D×(D+1)) transform to all Gaussian means
    (gmmbin/gmm-transform-means.cc)."""
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("gmm-transform-means <transform> <model-in> "
                      "<model-out>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{args[0]}: not binary kaldi")
        T = kio.read_matrix(f)
    tm, am = _host_mdl(args[1])
    D = am.dim
    A = T[:, :D]
    b = T[:, D] if T.shape[1] == D + 1 else np.zeros(D)
    am.means = am.means @ A.T + b
    am.refresh()
    write_mdl(args[2], tm, am)
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py gmm_make_regtree_tool.
@tool("gmm-make-regtree")
def gmm_make_regtree_tool(argv):
    """Build a regression tree over the model's Gaussians
    (gmmbin/gmm-make-regtree.cc)."""
    from kaldi_tpu_torch.am.regtree import RegressionTree, write_regtree
    po = ParseOptions("gmm-make-regtree [--max-leaves=4] <model-in> "
                      "<regtree-out>")
    po.register("max-leaves", int, 4, "number of base classes")
    args = po.read(argv)
    _tm, am = _host_mdl(args[0])
    tree = RegressionTree.build(am, num_base_classes=po["max-leaves"])
    write_regtree(args[1], tree)
    return 0


# Copied from kaldi_tpu/cli/tools_bank12.py analyze_counts_tool.
@tool("analyze-counts")
def analyze_counts_tool(argv):
    """Symbol occurrence counts over int-vector tables
    (bin/analyze-counts.cc): prints 'symbol count' sorted by count."""
    po = ParseOptions("analyze-counts [opts] <ints-rspec> <counts-out>")
    po.register("binary", bool, False, "(ignored; output is text)")
    args = po.read(argv)
    counts = {}
    n = 0
    for _key, vec in SequentialTableReader(args[0], holder="ivec"):
        for v in np.asarray(vec).ravel():
            counts[int(v)] = counts.get(int(v), 0) + 1
        n += 1
    out = (sys.stdout if args[1] == "-" else open(args[1], "w"))
    # Kaldi writes a bracketed count vector indexed by symbol
    top = max(counts) + 1 if counts else 0
    vec = [counts.get(i, 0) for i in range(top)]
    out.write("[ " + " ".join(str(c) for c in vec) + " ]\n")
    if args[1] != "-":
        out.close()
    log.info("analyze-counts: %d utterances, %d distinct symbols",
             n, len(counts))
    return 0
