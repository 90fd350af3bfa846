"""Port of kaldi_tpu/cli/tools_bank13.py's full-covariance GMM tools:
gmm-global-to-fgmm, fgmm-global-to-gmm, fgmm-global-copy,
fgmm-global-info, fgmm-global-acc-stats, fgmm-global-sum-accs,
fgmm-global-est, fgmm-global-get-frame-likes and fgmm-gselect (parity
targets gmmbin/gmm-global-to-fgmm.cc, fgmmbin/fgmm-global-*.cc,
fgmm-gselect.cc), registered in cli/tools.py's ``TOOLS``.

The file helpers are the original's, copied: a full GMM or its
accumulators written by either package read back the same and are
written again byte for byte.  The conversions, copies, sums and the
update are host numpy and take no ``--device``.  The three tools that
score frames (fgmm-global-acc-stats, fgmm-global-get-frame-likes,
fgmm-gselect) take ``--device`` (default cuda), where am/full_gmm.py
runs its float64 frame work.  apply-cmvn-online
(online2bin/apply-cmvn-online.cc) takes ``--device`` too: its trailing
windows are prefix sums there.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank13.py _write_full_gmm.
def _write_full_gmm(path: str, gmm) -> None:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<FullGMM>")
        kio.write_vector(f, gmm.weights.astype(np.float32))
        kio.write_matrix(f, gmm.means.astype(np.float32))
        kio.write_basic_int32(f, gmm.num_mix)
        for m in range(gmm.num_mix):
            kio.write_matrix(f, gmm.covars[m].astype(np.float32))
        kio.write_token(f, "</FullGMM>")


# Copied from kaldi_tpu/cli/tools_bank13.py _read_full_gmm (+ device).
def _read_full_gmm(path: str, device="cuda"):
    from kaldi_tpu_torch.am.full_gmm import FullGmm
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not a binary kaldi file")
        kio.expect_token(f, "<FullGMM>")
        weights = np.asarray(kio.read_vector(f), np.float64)
        means = np.asarray(kio.read_matrix(f), np.float64)
        M = kio.read_basic_int32(f)
        covars = np.stack([np.asarray(kio.read_matrix(f), np.float64)
                           for _ in range(M)])
        kio.expect_token(f, "</FullGMM>")
        return FullGmm(weights, means, covars, device=device)


# Copied from kaldi_tpu/cli/tools_bank13.py _write_full_accs.
def _write_full_accs(path: str, accs) -> None:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<FullGmmAccs>")
        kio.write_vector(f, accs.occ.astype(np.float64), dtype="float64")
        kio.write_matrix(f, accs.mean_acc.astype(np.float64),
                         dtype="float64")
        kio.write_basic_int32(f, len(accs.occ))
        for m in range(len(accs.occ)):
            kio.write_matrix(f, accs.cov_acc[m].astype(np.float64),
                             dtype="float64")
        kio.write_token(f, "</FullGmmAccs>")


# Copied from kaldi_tpu/cli/tools_bank13.py _read_full_accs.
def _read_full_accs(path: str):
    from kaldi_tpu_torch.am.full_gmm import AccumFullGmm
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not a binary kaldi file")
        kio.expect_token(f, "<FullGmmAccs>")
        occ = np.asarray(kio.read_vector(f), np.float64)
        mean_acc = np.asarray(kio.read_matrix(f), np.float64)
        M = kio.read_basic_int32(f)
        cov_acc = np.stack([np.asarray(kio.read_matrix(f), np.float64)
                            for _ in range(M)])
        kio.expect_token(f, "</FullGmmAccs>")
        accs = AccumFullGmm(len(occ), mean_acc.shape[1])
        accs.occ, accs.mean_acc, accs.cov_acc = occ, mean_acc, cov_acc
        return accs


# Copied from kaldi_tpu/cli/tools_bank13.py gmm_global_to_fgmm_tool.
@tool("gmm-global-to-fgmm")
def gmm_global_to_fgmm_tool(argv):
    """Diagonal global GMM → full-covariance GMM
    (gmmbin/gmm-global-to-fgmm.cc; train_full_ubm.sh start)."""
    from kaldi_tpu_torch.am.full_gmm import FullGmm
    from kaldi_tpu_torch.cli.tools_bank5 import _read_global_gmm
    po = ParseOptions("gmm-global-to-fgmm <gmm-in> <fgmm-out>")
    args = po.read(argv)
    am = _read_global_gmm(args[0], "cpu")
    w = am.weights[0]
    keep = w > 0
    gmm = FullGmm.from_diag(w[keep], am.means[0][keep], am.vars[0][keep],
                            device="cpu")
    _write_full_gmm(args[1], gmm)
    log.info("gmm-global-to-fgmm: %d gaussians, dim %d",
             gmm.num_mix, gmm.dim)
    return 0


# Copied from kaldi_tpu/cli/tools_bank13.py fgmm_global_to_gmm_tool.
@tool("fgmm-global-to-gmm")
def fgmm_global_to_gmm_tool(argv):
    """Full-covariance GMM → diagonal (keeps the covariance diagonal;
    fgmmbin/fgmm-global-to-gmm.cc)."""
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.cli.tools_bank5 import _write_global_gmm
    po = ParseOptions("fgmm-global-to-gmm <fgmm-in> <gmm-out>")
    args = po.read(argv)
    gmm = _read_full_gmm(args[0], "cpu")
    variances = np.stack([np.diag(gmm.covars[m])
                          for m in range(gmm.num_mix)])
    am = AmDiagGmm(gmm.weights[None, :], gmm.means[None, :, :],
                   variances[None, :, :], device="cpu")
    _write_global_gmm(args[1], am)
    return 0


# Copied from kaldi_tpu/cli/tools_bank13.py fgmm_global_copy_tool.
@tool("fgmm-global-copy")
def fgmm_global_copy_tool(argv):
    """Copy a full-covariance GMM (fgmmbin/fgmm-global-copy.cc)."""
    po = ParseOptions("fgmm-global-copy <fgmm-in> <fgmm-out>")
    args = po.read(argv)
    _write_full_gmm(args[1], _read_full_gmm(args[0], "cpu"))
    return 0


# Copied from kaldi_tpu/cli/tools_bank13.py fgmm_global_info_tool.
@tool("fgmm-global-info")
def fgmm_global_info_tool(argv):
    """Print dims of a full-covariance GMM (fgmmbin/fgmm-global-info.cc)."""
    po = ParseOptions("fgmm-global-info <fgmm-in>")
    args = po.read(argv)
    gmm = _read_full_gmm(args[0], "cpu")
    print(f"number of gaussians {gmm.num_mix}")
    print(f"feature dimension {gmm.dim}")
    return 0


# Port of kaldi_tpu/cli/tools_bank13.py fgmm_global_acc_stats_tool.
@tool("fgmm-global-acc-stats")
def fgmm_global_acc_stats_tool(argv):
    """Accumulate full-covariance sufficient stats over a feature table
    (fgmmbin/fgmm-global-acc-stats.cc), on ``--device``."""
    from kaldi_tpu_torch.am.full_gmm import AccumFullGmm
    po = ParseOptions("fgmm-global-acc-stats <fgmm-in> <feats-rspec> "
                      "<accs-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    gmm = _read_full_gmm(args[0], resolve_device(po["device"]))
    accs = AccumFullGmm(gmm.num_mix, gmm.dim)
    tot_like, tot_t, n = 0.0, 0, 0
    for _key, feats in SequentialTableReader(args[1], holder="mat"):
        feats = np.asarray(feats)
        tot_like += accs.accumulate(gmm, feats)
        tot_t += len(feats)
        n += 1
    _write_full_accs(args[2], accs)
    log.info("fgmm-global-acc-stats: %d utts, avg like/frame %.4f",
             n, tot_like / max(tot_t, 1))
    return 0


# Copied from kaldi_tpu/cli/tools_bank13.py fgmm_global_sum_accs_tool.
@tool("fgmm-global-sum-accs")
def fgmm_global_sum_accs_tool(argv):
    """Sum full-covariance stats files (fgmmbin/fgmm-global-sum-accs.cc)."""
    po = ParseOptions("fgmm-global-sum-accs <accs-out> <accs-in1> ...")
    args = po.read(argv)
    total = _read_full_accs(args[1])
    for path in args[2:]:
        a = _read_full_accs(path)
        total.occ += a.occ
        total.mean_acc += a.mean_acc
        total.cov_acc += a.cov_acc
    _write_full_accs(args[0], total)
    return 0


# Copied from kaldi_tpu/cli/tools_bank13.py fgmm_global_est_tool.
@tool("fgmm-global-est")
def fgmm_global_est_tool(argv):
    """Re-estimate a full-covariance GMM from stats
    (fgmmbin/fgmm-global-est.cc)."""
    from kaldi_tpu_torch.am.full_gmm import mle_full_gmm_update
    po = ParseOptions("fgmm-global-est [--min-occ=10] <fgmm-in> "
                      "<accs-in> <fgmm-out>")
    po.register("min-occ", float, 10.0, "skip components below this count")
    po.register("cov-floor", float, 1e-3, "covariance eigenvalue floor")
    args = po.read(argv)
    gmm = _read_full_gmm(args[0], "cpu")
    accs = _read_full_accs(args[1])
    mle_full_gmm_update(gmm, accs, min_occ=po["min-occ"],
                        cov_floor=po["cov-floor"])
    _write_full_gmm(args[2], gmm)
    log.info("fgmm-global-est: total occupancy %.1f", float(accs.occ.sum()))
    return 0


# Port of kaldi_tpu/cli/tools_bank13.py fgmm_global_get_frame_likes_tool.
@tool("fgmm-global-get-frame-likes")
def fgmm_global_get_frame_likes_tool(argv):
    """Per-frame (or per-utterance average) log-likelihoods under a
    full-covariance GMM (fgmmbin/fgmm-global-get-frame-likes.cc), on
    ``--device``."""
    po = ParseOptions("fgmm-global-get-frame-likes [--average=false] "
                      "<fgmm-in> <feats-rspec> <likes-wspec>")
    po.register("average", bool, False,
                "write one average like per utterance")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    gmm = _read_full_gmm(args[0], resolve_device(po["device"]))
    with TableWriter(args[2], holder="vec") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            likes = gmm.loglikes(np.asarray(feats)).cpu().numpy()
            if po["average"]:
                likes = np.array([likes.mean()])
            w[key] = likes.astype(np.float32)
    return 0


# Port of kaldi_tpu/cli/tools_bank13.py fgmm_gselect_tool.
@tool("fgmm-gselect")
def fgmm_gselect_tool(argv):
    """Top-N Gaussian indices per frame under a full-covariance GMM
    (fgmmbin/fgmm-gselect.cc), the posteriors on ``--device``."""
    po = ParseOptions("fgmm-gselect [--n=50] <fgmm-in> <feats-rspec> "
                      "<gselect-wspec>")
    po.register("n", int, 50, "Gaussians to keep per frame")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    gmm = _read_full_gmm(args[0], resolve_device(po["device"]))
    n_keep = min(po["n"], gmm.num_mix)
    with TableWriter(args[2], holder="post") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            post = gmm.posteriors(np.asarray(feats)).cpu().numpy()
            idx = np.argsort(-post, axis=1)[:, :n_keep]
            w[key] = [[(int(i), float(post[t, i])) for i in idx[t]]
                      for t in range(len(post))]
    return 0


# Port of kaldi_tpu/cli/tools_bank13.py apply_cmvn_online_tool.
@tool("apply-cmvn-online")
def apply_cmvn_online_tool(argv):
    """Causal CMVN: per frame t, mean (and optionally variance) stats
    from the trailing window [t-W+1, t]; when fewer than W frames are
    available, the deficit is padded with the supplied global stats —
    the online2 decoding contract (online2bin/apply-cmvn-online.cc).
    The original's frame loop runs as prefix sums over the utterance on
    ``--device``, in float64 as there."""
    import torch
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("apply-cmvn-online [--cmn-window=600] "
                      "[--norm-vars=false] <global-stats-in> "
                      "<feats-rspec> <feats-wspec>")
    po.register("cmn-window", int, 600, "trailing window, frames")
    po.register("norm-vars", bool, False, "also normalize variance")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        gstats = np.asarray(kio.read_matrix(f), np.float64)
    W = po["cmn-window"]
    gcount = float(gstats[0, -1])
    g = torch.from_numpy(gstats[:, :-1]).to(device)
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            x = torch.as_tensor(np.asarray(feats, np.float64)).to(device)
            T, D = x.shape
            zero = x.new_zeros((1, D))
            csum = torch.cat([zero, x.cumsum(0)])
            csumsq = torch.cat([zero, (x * x).cumsum(0)])
            t = torch.arange(T, device=device)
            lo = (t - W + 1).clamp_min(0)
            cnt = (t - lo + 1).to(torch.float64)[:, None]
            s = csum[t + 1] - csum[lo]
            ss = csumsq[t + 1] - csumsq[lo]
            if gcount > 0:
                deficit = (W - cnt).clamp_min(0)
                s = s + deficit / gcount * g[0]
                ss = ss + deficit / gcount * g[1]
                cnt = cnt + deficit
            mean = s / cnt
            out = x - mean
            if po["norm-vars"]:
                var = torch.clamp(ss / cnt - mean * mean, min=1e-10)
                out = out / torch.sqrt(var)
            w[key] = out.to(torch.float32).cpu().numpy()
    return 0
