"""Port of kaldi_tpu/cli/tools_bank17.py's sequence-training posteriors
(lattice-to-smbr-post, lattice-to-mpe-post; parity targets
latbin/lattice-to-smbr-post.cc, lattice-to-mpe-post.cc) and keyword-search
index tools (lattice-to-kws-index, kws-index-union; kwsbin/), registered
in cli/tools.py's ``TOOLS``.  All four are the original's host code,
copied (kws.py's ``LatticeIndex`` and its file format; the posteriors'
forward-backward over CompactLattices); none takes ``--device``.
online2-wav-dump-features (online2bin/online2-wav-dump-features.cc)
takes ``--device`` (default cuda): the online MFCC's fbank kernel runs
there, one launch a chunk.  gmm-est-regtree-fmllr
(gmmbin/gmm-est-regtree-fmllr.cc) computes its statistics' mixture
posteriors on ``--device`` and estimates on the host (am/regtree.py).
"""

from __future__ import annotations

from typing import List

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank17.py _seq_posteriors.
def _seq_posteriors(clat, tm, ref_tids, acoustic_scale, unit):
    """Shared smbr/mpe posterior computation: per-frame pdf-level
    posteriors weighted by gamma * (accuracy - expected accuracy)
    (src/lat/lattice-functions.cc LatticeForwardBackwardMpeVariants).
    unit='pdf' → sMBR (state-level accuracy), 'phone' → MPE."""
    import math
    from kaldi_tpu_torch.lattice.functions import state_times

    def arc_ll(a):
        return -(a.graph_cost + acoustic_scale * a.acoustic_cost)

    order = clat.top_order()
    nstates = clat.num_states
    times = state_times(clat)
    NEG = -np.inf
    alpha = np.full(nstates, NEG)
    alpha[clat.start] = 0.0

    def ladd(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + math.log1p(math.exp(-abs(a - b)))

    for s in order:
        if alpha[s] == NEG:
            continue
        for a in clat.arcs[s]:
            alpha[a.nextstate] = ladd(alpha[a.nextstate],
                                      alpha[s] + arc_ll(a))
    beta = np.full(nstates, NEG)
    for s, (gc, ac, _t) in clat.finals.items():
        beta[s] = -(gc + acoustic_scale * ac)
    for s in reversed(order):
        for a in clat.arcs[s]:
            beta[s] = ladd(beta[s], arc_ll(a) + beta[a.nextstate])
    total = beta[clat.start]

    def acc_of(tid, t):
        if t >= len(ref_tids):
            return 0.0
        if unit == "phone":
            return float(tm.transition_id_to_phone(int(tid))
                         == tm.transition_id_to_phone(
                             int(ref_tids[t])))
        return float(tm.transition_id_to_pdf(int(tid))
                     == tm.transition_id_to_pdf(int(ref_tids[t])))

    # arc-level gamma and accuracy
    arcs_info = []
    exp_acc = 0.0
    for s in order:
        if alpha[s] == NEG:
            continue
        for a in clat.arcs[s]:
            g = math.exp(alpha[s] + arc_ll(a) + beta[a.nextstate]
                         - total)
            accs = [acc_of(tid, times[s] + i)
                    for i, tid in enumerate(a.tids)]
            arcs_info.append((s, a, g, accs))
            exp_acc += g * sum(accs)
    # smbr/mpe posterior per (t, pdf): gamma * (arc path accuracy
    # contribution - expected); the standard per-frame decomposition
    T = max((times[s] + len(f[2]) for s, f in clat.finals.items()),
            default=0)
    post: List[List] = [dict() for _ in range(T)]
    for s, a, g, accs in arcs_info:
        for i, tid in enumerate(a.tids):
            t = times[s] + i
            pdf = tm.transition_id_to_pdf(int(tid))
            wgt = g * (accs[i] - exp_acc / max(T, 1))
            post[t][pdf] = post[t].get(pdf, 0.0) + wgt
    return [[(p, w) for p, w in sorted(fr.items())] for fr in post]


# Copied from kaldi_tpu/cli/tools_bank17.py _seq_post_main.
def _seq_post_main(argv, unit, name):
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions(f"{name} [opts] <model> <ali-rspec> <clat-rspec> "
                      "<post-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    ali_r = RandomAccessTableReader(args[1], holder="ivec")
    n = 0
    with TableWriter(args[3], holder="post") as w:
        for key, clat in SequentialTableReader(args[2], holder="clat"):
            if key not in ali_r:
                log.warning("%s: no alignment for %s", name, key)
                continue
            w[key] = _seq_posteriors(clat, tm,
                                     np.asarray(ali_r[key]).tolist(),
                                     po["acoustic-scale"], unit)
            n += 1
    log.info("%s: %d lattices", name, n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank17.py lattice_to_smbr_post_tool.
@tool("lattice-to-smbr-post")
def lattice_to_smbr_post_tool(argv):
    """State-level minimum-Bayes-risk posteriors for sequence training
    (latbin/lattice-to-smbr-post.cc)."""
    return _seq_post_main(argv, "pdf", "lattice-to-smbr-post")


# Copied from kaldi_tpu/cli/tools_bank17.py lattice_to_mpe_post_tool.
@tool("lattice-to-mpe-post")
def lattice_to_mpe_post_tool(argv):
    """Minimum-phone-error posteriors (latbin/lattice-to-mpe-post.cc)."""
    return _seq_post_main(argv, "phone", "lattice-to-mpe-post")


# Copied from kaldi_tpu/cli/tools_bank17.py lattice_to_kws_index_tool.
@tool("lattice-to-kws-index")
def lattice_to_kws_index_tool(argv):
    """Build the inverted keyword-search index from lattices
    (kwsbin/lattice-to-kws-index.cc; the factor-transducer role)."""
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.kws import LatticeIndex, write_lattice_index
    po = ParseOptions("lattice-to-kws-index [opts] <clat-rspec> "
                      "<index-out>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    args = po.read(argv)
    lattices = dict(SequentialTableReader(args[0], holder="clat"))
    idx = LatticeIndex.build(lattices,
                             acoustic_scale=po["acoustic-scale"])
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        write_lattice_index(f, idx)
    log.info("lattice-to-kws-index: indexed %d lattices, %d words",
             len(idx.utts), len(idx.postings))
    return 0


# Copied from kaldi_tpu/cli/tools_bank17.py kws_index_union_tool.
@tool("kws-index-union")
def kws_index_union_tool(argv):
    """Union index shards (kwsbin/kws-index-union.cc)."""
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.kws import (merge_indexes, read_lattice_index,
                                     write_lattice_index)
    po = ParseOptions("kws-index-union <index-out> <index-in1> "
                      "[<index-in2> ...]")
    args = po.read(argv)
    parts = []
    for path in args[1:]:
        with kio.open_rxfilename(path) as f:
            kio.init_kaldi_input_stream(f)
            parts.append(read_lattice_index(f))
    idx = merge_indexes(parts)
    with kio.open_wxfilename(args[0]) as f:
        kio.init_kaldi_output_stream(f)
        write_lattice_index(f, idx)
    log.info("kws-index-union: %d shards → %d utterances", len(parts),
             len(idx.utts))
    return 0


# Port of kaldi_tpu/cli/tools_bank17.py online2_wav_dump_features_tool.
@tool("online2-wav-dump-features")
def online2_wav_dump_features_tool(argv):
    """Run the ONLINE feature pipeline over wav chunks and dump the
    features (online2bin/online2-wav-dump-features.cc) — proves the
    streaming frontend, chunk by chunk: one fbank launch a chunk on
    ``--device``."""
    import torch
    from kaldi_tpu_torch.cli.online2 import online_mfcc
    from kaldi_tpu_torch.cli.tools import _device_po
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
    po = ParseOptions("online2-wav-dump-features [opts] <wav-rspec> "
                      "<feats-wspec>")
    po.register("chunk-length", float, 0.18, "seconds per chunk")
    po.register("num-ceps", int, 13, "cepstra")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    computers = {}
    n = 0
    with TableWriter(args[1], holder="mat") as w:
        for key, (wave, rate) in SequentialTableReader(args[0],
                                                       holder="wav"):
            if rate not in computers:
                computers[rate] = online_mfcc(rate, device, po["num-ceps"])
            pipe = OnlineFeaturePipeline(computers[rate])
            step = max(1, int(po["chunk-length"] * rate))
            rows = []
            fed = 0
            for i in range(0, len(wave), step):
                pipe.accept_waveform(np.asarray(wave[i:i + step],
                                                np.float32))
                ready = pipe.num_frames_ready()
                if ready > fed:
                    rows.append(pipe.get_frames(fed, ready))
                    fed = ready
            pipe.input_finished()
            ready = pipe.num_frames_ready()
            if ready > fed:
                rows.append(pipe.get_frames(fed, ready))
            w[key] = torch.cat(rows).cpu().numpy()
            n += 1
    log.info("online2-wav-dump-features: %d utterances; fbank kernel "
             "launches %d", n, sum(c.kernel.launches
                                   for c in computers.values()))
    return 0


# Port of kaldi_tpu/cli/tools_bank17.py gmm_est_regtree_fmllr_tool.
@tool("gmm-est-regtree-fmllr")
def gmm_est_regtree_fmllr_tool(argv):
    """Per-speaker regression-tree fMLLR transforms
    (gmmbin/gmm-est-regtree-fmllr.cc); writes the root node's
    transform per speaker (usable by transform-feats).  The mixture
    posteriors run on ``--device``."""
    from kaldi_tpu_torch.am.regtree import RegressionTree, RegtreeFmllrAccs
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools import _device_po
    from kaldi_tpu_torch.device import resolve_device
    po = ParseOptions("gmm-est-regtree-fmllr [opts] "
                      "[--spk2utt=rspec] <model-in> <feats-rspec> "
                      "<ali-rspec> <transform-wspec>")
    po.register("num-base-classes", int, 4, "regression-tree leaves")
    po.register("min-count", float, 200.0, "occupancy gate")
    po.register("spk2utt", str, "", "speaker→utterances map")
    _device_po(po)
    args = po.read(argv)
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    tree = RegressionTree.build(am, po["num-base-classes"])
    feats_r = RandomAccessTableReader(args[1], holder="mat")
    ali_r = RandomAccessTableReader(args[2], holder="ivec")
    groups = {}
    if po["spk2utt"]:
        for spk, utts in SequentialTableReader(po["spk2utt"],
                                               holder="text"):
            groups[spk] = list(utts)
    else:
        for key, _ in SequentialTableReader(args[1], holder="mat"):
            groups[key] = [key]
    n = 0
    with TableWriter(args[3], holder="mat") as w:
        for spk, utts in groups.items():
            accs = RegtreeFmllrAccs(tree, am.dim)
            got = False
            for u in utts:
                if u in feats_r and u in ali_r:
                    ali = np.asarray(ali_r[u], np.int32)
                    pdf = np.asarray(
                        [tm.transition_id_to_pdf(int(t)) for t in ali],
                        np.int32)
                    accs.accumulate(am, np.asarray(feats_r[u]), pdf)
                    got = True
            if not got:
                continue
            est = accs.estimate(min_count=po["min-count"])
            w[spk] = est.root_transform().astype(np.float32)
            n += 1
    log.info("gmm-est-regtree-fmllr: %d speakers", n)
    return 0
