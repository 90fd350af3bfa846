"""VAD and i-vector tools (ivectorbin/, online2bin/ivector-extract-online2).

Port of ``compute-vad`` (kaldi_tpu/cli/tools.py), ``select-voiced-frames``
(tools_bank7.py), ``ivector-extractor-init``, ``-acc-stats``,
``-sum-accs``, ``-est`` and ``ivector-extract-online2`` (tools_bank17.py),
``ivector-extract`` (tools_bank3.py), ``ivector-extract-online``
(tools_bank9.py) and ``ivector-extractor-copy`` (tools_bank30.py),
registered in cli/tools.py's ``TOOLS``.  Each keeps the original's
options and arguments; those that compute with an extractor or features
add ``--device`` (default cuda), where am/ivector.py runs its float64
work.  The stats file is the original's (``<IvectorStats>`` around a
``write_pytree``).  The steps/online/nnet2 recipe runs them as
gmm-global-init-from-feats → gmm-global-acc-stats → gmm-global-est
(tools_bank5.py) → ivector-extractor-init → ivector-extractor-acc-stats
(per job) → ivector-extractor-sum-accs → ivector-extractor-est →
ivector-extract-online2.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, _host, tool
from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools.py compute_vad_tool.
@tool("compute-vad")
def compute_vad_tool(argv):
    from kaldi_tpu_torch.am.ivector import VadEnergyOptions, \
        compute_vad_energy
    po = ParseOptions("compute-vad <feats-rspec> <vad-wspec>")
    po.register("vad-energy-threshold", float, 5.0, "")
    po.register("vad-energy-mean-scale", float, 0.5, "")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    opts = VadEnergyOptions(po["vad-energy-threshold"],
                            po["vad-energy-mean-scale"])
    with TableWriter(args[1], holder="vec") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = _host(compute_vad_energy(mat, opts, device=device))
    return 0


# Copied from kaldi_tpu/cli/tools_bank7.py select_voiced_frames.
@tool("select-voiced-frames")
def select_voiced_frames(argv):
    """Keep only frames the VAD marked voiced
    (ivectorbin/select-voiced-frames.cc)."""
    po = ParseOptions(
        "select-voiced-frames <feats-rspec> <vad-rspec> <feats-wspec>")
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    vad = RandomAccessTableReader(args[1], holder="vec")
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, m in SequentialTableReader(args[0], holder="mat"):
            if key not in vad:
                log.warning("%s: no VAD; skipped", key)
                continue
            v = np.asarray(vad[key]) > 0.5
            m = np.asarray(m)
            T = min(len(v), m.shape[0])
            sel = m[:T][v[:T]]
            if sel.shape[0] == 0:
                log.warning("%s: no voiced frames; skipped", key)
                continue
            w[key] = sel
            n += 1
    log.info("selected voiced frames for %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# i-vector extractor training (map-reduce EM, the accs/sum/est contract)
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank17.py ivector_extractor_init_tool.
@tool("ivector-extractor-init")
def ivector_extractor_init_tool(argv):
    """Initialize the total-variability extractor from a (diag) UBM
    (ivectorbin/ivector-extractor-init.cc)."""
    from kaldi_tpu_torch.am.ivector import (IvectorExtractor,
                                            write_ivector_extractor)
    from kaldi_tpu_torch.cli.tools_bank5 import _read_global_gmm
    po = ParseOptions("ivector-extractor-init [opts] <ubm-in> "
                      "<extractor-out>")
    po.register("ivector-dim", int, 100, "i-vector dimension")
    po.register("seed", int, 0, "T init seed")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    am = _read_global_gmm(args[0], "cpu")
    ex = IvectorExtractor.from_am(am, po["ivector-dim"], device=device)
    ex.T = 0.1 * np.random.default_rng(po["seed"]).standard_normal(
        tuple(ex.T.shape))
    write_ivector_extractor(args[1], ex)
    log.info("ivector-extractor-init: %d gaussians, dim %d",
             ex.T.shape[0], po["ivector-dim"])
    return 0


def _write_iv_stats(path: str, stats) -> None:
    from kaldi_tpu_torch.am.serialize import write_pytree
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<IvectorStats>")
        write_pytree(f, stats)
        kio.write_token(f, "</IvectorStats>")


# Port of kaldi_tpu/cli/tools_bank17.py ivector_extractor_acc_stats_tool.
@tool("ivector-extractor-acc-stats")
def ivector_extractor_acc_stats_tool(argv):
    """Accumulate EM stats for the extractor over a job's feats
    (ivectorbin/ivector-extractor-acc-stats.cc): every utterance's
    posterior solve in one batch on the device."""
    from kaldi_tpu_torch.am.ivector import read_ivector_extractor
    po = ParseOptions("ivector-extractor-acc-stats <extractor-in> "
                      "<feats-rspec> <stats-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    ex = read_ivector_extractor(args[0], resolve_device(po["device"]))
    utt_stats = [ex.acc_stats(np.asarray(m)) for _k, m in
                 SequentialTableReader(args[1], holder="mat")]
    A, B, gamma = ex.em_stats(utt_stats)
    _write_iv_stats(args[2], {"A": _host(A), "B": _host(B),
                              "gamma": _host(gamma),
                              "num_utts": np.int64(len(utt_stats))})
    log.info("ivector-extractor-acc-stats: %d utterances",
             len(utt_stats))
    return 0


# Copied from kaldi_tpu/cli/tools_bank17.py _read_iv_stats.
def _read_iv_stats(path):
    from kaldi_tpu_torch.am.serialize import read_pytree
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<IvectorStats>")
        d = read_pytree(f)
        kio.expect_token(f, "</IvectorStats>")
    return d


# Copied from kaldi_tpu/cli/tools_bank17.py ivector_extractor_sum_accs_tool.
@tool("ivector-extractor-sum-accs")
def ivector_extractor_sum_accs_tool(argv):
    """Sum per-job extractor stats
    (ivectorbin/ivector-extractor-sum-accs.cc); host numpy."""
    po = ParseOptions("ivector-extractor-sum-accs <stats-out> "
                      "<stats-in1> [<stats-in2> ...]")
    args = po.read(argv)
    if len(args) < 2:
        po.print_usage()
        return 1
    tot = None
    for path in args[1:]:
        d = _read_iv_stats(path)
        if tot is None:
            tot = d
        else:
            for k in ("A", "B", "gamma", "num_utts"):
                tot[k] = tot[k] + d[k]
    _write_iv_stats(args[0], tot)
    log.info("ivector-extractor-sum-accs: %d inputs", len(args) - 1)
    return 0


# Port of kaldi_tpu/cli/tools_bank17.py ivector_extractor_est_tool.
@tool("ivector-extractor-est")
def ivector_extractor_est_tool(argv):
    """M-step update of T from summed stats
    (ivectorbin/ivector-extractor-est.cc): one batched solve over the
    Gaussians on the device."""
    from kaldi_tpu_torch.am.ivector import (read_ivector_extractor,
                                            write_ivector_extractor)
    po = ParseOptions("ivector-extractor-est <extractor-in> <stats-in> "
                      "<extractor-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    ex = read_ivector_extractor(args[0], resolve_device(po["device"]))
    d = _read_iv_stats(args[1])
    ex.em_update(d["A"], d["B"], d["gamma"])
    write_ivector_extractor(args[2], ex)
    log.info("ivector-extractor-est: updated from %.0f frames of "
             "stats", float(d["gamma"].sum()))
    return 0


# Port of kaldi_tpu/cli/tools_bank30.py ivector_extractor_copy_tool.
@tool("ivector-extractor-copy")
def ivector_extractor_copy_tool(argv):
    """Copy an i-vector extractor (ivectorbin/ivector-extractor-copy.cc)."""
    from kaldi_tpu_torch.am.ivector import (read_ivector_extractor,
                                            write_ivector_extractor)
    po = ParseOptions("ivector-extractor-copy <extractor-in> "
                      "<extractor-out>")
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    # a copy computes nothing: the extractor is read on the CPU
    ex = read_ivector_extractor(args[0], "cpu")
    write_ivector_extractor(args[1], ex)
    log.info("ivector-extractor-copy: %d Gaussians, ivector dim %d",
             ex.means.shape[0], ex.ivector_dim)
    return 0


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank3.py ivector_extract.
@tool("ivector-extract")
def ivector_extract(argv):
    from kaldi_tpu_torch.am.ivector import read_ivector_extractor
    po = ParseOptions("ivector-extract <extractor> <feats-rspec> "
                      "<ivector-wspec>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    ex = read_ivector_extractor(args[0], resolve_device(po["device"]))
    with TableWriter(args[2], holder="vec") as w:
        for key, m in SequentialTableReader(args[1], holder="mat"):
            w[key] = _host(ex.extract_from_feats(np.asarray(m))).astype(
                np.float32)
    return 0


def _per_period(est, feats: np.ndarray, period: int) -> np.ndarray:
    """The estimator fed ``period`` frames at a time → one row (float64)
    per block, the estimate after it."""
    rows = []
    for t0 in range(0, feats.shape[0], period):
        est.accept_frames(feats[t0:t0 + period])
        rows.append(est.ivector())
    return _host(torch.stack(rows)) if rows else \
        np.zeros((0, est.ex.ivector_dim))


# Port of kaldi_tpu/cli/tools_bank9.py ivector_extract_online.
@tool("ivector-extract-online")
def ivector_extract_online(argv):
    """Online i-vector extraction: one i-vector row per
    --ivector-period frames, estimate updated causally
    (ivectorbin/ivector-extract-online.cc)."""
    from kaldi_tpu_torch.am.ivector import (OnlineIvectorEstimator,
                                            read_ivector_extractor)
    po = ParseOptions("ivector-extract-online [opts] <extractor> "
                      "<feats-rspec> <ivectors-wspec>")
    po.register("ivector-period", int, 10, "frames between estimates")
    po.register("max-count", float, 0.0, "stats count cap")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    ex = read_ivector_extractor(args[0], resolve_device(po["device"]))
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            est = OnlineIvectorEstimator(ex, max_count=po["max-count"])
            rows = _per_period(est, np.asarray(feats), po["ivector-period"])
            w[key] = rows if len(rows) else \
                np.zeros((0, ex.ivector_dim), np.float32)
            n += 1
    log.info("ivector-extract-online: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank17.py ivector_extract_online2_tool.
@tool("ivector-extract-online2")
def ivector_extract_online2_tool(argv):
    """Online i-vectors re-estimated every --ivector-period frames,
    per speaker across utterances
    (online2bin/ivector-extract-online2.cc)."""
    from kaldi_tpu_torch.am.ivector import (OnlineIvectorEstimator,
                                            read_ivector_extractor)
    po = ParseOptions("ivector-extract-online2 [opts] <spk2utt-rspec> "
                      "<extractor-in> <feats-rspec> <ivector-wspec>")
    po.register("ivector-period", int, 10, "frames between estimates")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    ex = read_ivector_extractor(args[1], resolve_device(po["device"]))
    feats_r = RandomAccessTableReader(args[2], holder="mat")
    n = 0
    with TableWriter(args[3], holder="mat") as w:
        for spk, utts in SequentialTableReader(args[0], holder="text"):
            est = OnlineIvectorEstimator(ex)
            for u in utts:
                if u not in feats_r:
                    continue
                w[u] = _per_period(est, np.asarray(feats_r[u]),
                                   po["ivector-period"]).astype(np.float32)
                n += 1
    log.info("ivector-extract-online2: %d utterances", n)
    return 0
