"""Port of kaldi_tpu/cli/tools_bank31.py nnet3-latgen-incremental (parity
target nnet3bin/nnet3-latgen-incremental.cc) and of its nnet2 tools
(nnet2bin/{nnet-am-limit-rank, nnet-am-reinitialize,
nnet-compute-from-egs, nnet-modify-learning-rates,
nnet-get-feature-transform, nnet-get-feature-transform-multi,
nnet-normalize-stddev, nnet-train-discriminative-simple,
nnet-train-discriminative-parallel}.cc), registered in cli/tools.py's
``TOOLS``.  nnet3-latgen-incremental takes ``--device``
(default cuda): the raw TDNN-F scores each utterance there, and
``OnlineBeamDecoder`` (decoder/online_beam.py) advances over the scores
there ``--chunk-frames`` at a time, its lattice finalized at the
utterance's end.  nnet-compute-from-egs forwards the egs on
``--device``; the three model tools are host numpy on flax's parameter
tree (nnet-am-reinitialize draws from ``np.random.default_rng(srand)``
as the original does), and so are the two feature-transform tools
(``LdaEstimate`` over ``<LDAACCS>`` files, copied, so their matrices
equal the original's).  nnet-normalize-stddev and the two
discriminative trainers take ``--device``: the layers' products, and
the model, the MMI / sMBR frame loop (am/discriminative.py) and Adam,
run there (am/nnet2.py ``normalize_stddev``, ``train_discriminative``).
The trainers keep the original's scores, log-softmax with no log-priors
(ROADMAP, "Reference faults to port to intent").
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


def incremental_decoder(mdl: str, fst: str, po, device,
                        chunk_frames: int = 32,
                        record_capacity: int = 16384):
    """(transition model, ``OnlineBeamDecoder`` over the graph ``fst`` on
    ``device``, advancing ``chunk_frames`` at a time) from the latgen
    options in ``po`` (beam, lattice-beam, max-active, acoustic-scale):
    the set-up the original's incremental tools share."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.decoder.online_beam import OnlineBeamDecoder
    from kaldi_tpu_torch.fst.csr import pack_fst
    tm, _ = read_mdl(mdl, device="cpu")
    cap = max(po["max-active"], 512)
    dec = BeamDecoder(pack_fst(_load_hclg(fst)), tm.tid_to_pdf_array,
                      BeamDecoderConfig(
                          beam=po["beam"],
                          lattice_beam=po["lattice-beam"],
                          acoustic_scale=po["acoustic-scale"],
                          max_active=po["max-active"],
                          lattice_arcs_per_frame=max(2 * cap, 4096),
                          record_capacity=record_capacity), device=device)
    return tm, OnlineBeamDecoder(dec, chunk_frames=chunk_frames)


# Port of kaldi_tpu/cli/tools_bank31.py nnet3_latgen_incremental_tool.
@tool("nnet3-latgen-incremental")
def nnet3_latgen_incremental_tool(argv):
    """nnet3 lattice decoding with chunked advance and incrementally
    finalized lattices (nnet3bin/nnet3-latgen-incremental.cc): the
    TDNN scores the whole utterance in one forward, then the online
    beam decoder consumes --chunk-frames at a time so decoder state
    stays bounded."""
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("nnet3-latgen-incremental [opts] <trans-model> "
                      "<raw-nnet3> <fst> <feats-rspec> <lat-wspec> "
                      "[<words-wspec>]")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("chunk-frames", int, 32, "decoder frames per advance")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, ob = incremental_decoder(args[0], args[2], po, device,
                                  chunk_frames=po["chunk-frames"])
    _, net = _load_tdnn(args[1], po["frame-subsampling-factor"], device)
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    ww = TableWriter(args[5], holder="text") if len(args) > 5 else None
    C = po["chunk-frames"]
    n = 0
    with TableWriter(args[4], holder="clat") as lw, torch.no_grad():
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            scores = net(x[None])[0]
            ob.reset()
            for c in range(0, len(scores), C):
                ob.advance(scores[c:c + C])
            clat = ob.finalize()
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w)
                    for w in wseq]
            if ww:
                ww[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
    if ww:
        ww.close()
    log.info("nnet3-latgen-incremental: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# nnet2bin model surgery and forward
# ---------------------------------------------------------------------------

def _flat_leaves(tree):
    """A parameter tree's leaves as float64, in jax's (sorted-key)
    order."""
    from kaldi_tpu_torch.am.nnet2 import tree_leaves
    return [np.asarray(x, np.float64) for _p, x in tree_leaves(dict(tree))]


# Port of kaldi_tpu/cli/tools_bank31.py nnet_am_limit_rank_tool.
@tool("nnet-am-limit-rank")
def nnet_am_limit_rank_tool(argv):
    """SVD-truncate each hidden affine's weight matrix to a reduced
    rank, keeping the reconstruction W ≈ U_k Σ_k V_kᵀ in place
    (nnet2bin/nnet-am-limit-rank.cc)."""
    from kaldi_tpu_torch.am.nnet2 import (layer_names, load_nnet2_full,
                                          save_nnet2)
    po = ParseOptions("nnet-am-limit-rank [opts] <nnet2-in> "
                      "<nnet2-out>")
    po.register("dim", int, 0, "rank to keep (0 ⇒ use "
                "--parameter-proportion)")
    po.register("parameter-proportion", float, 0.75,
                "fraction of parameters to retain when --dim=0")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    params = dict(params)
    for name in layer_names(cfg)[:-1]:   # hidden layers only
        layer = {k: np.asarray(v) for k, v in
                 dict(params[name]["affine"]).items()}
        W = layer["kernel"].astype(np.float64)  # (in, out)
        full = min(W.shape)
        if po["dim"] > 0:
            k = min(po["dim"], full)
        else:
            # rank such that the factored form U_k, V_k holds
            # parameter-proportion of the original matrix's params
            k = max(1, int(po["parameter-proportion"] * W.size
                           / (W.shape[0] + W.shape[1])))
            k = min(k, full)
        U, S, Vt = np.linalg.svd(W, full_matrices=False)
        kept = float((S[:k] ** 2).sum() / max((S ** 2).sum(), 1e-30))
        layer["kernel"] = ((U[:, :k] * S[:k]) @ Vt[:k]).astype(np.float32)
        params[name] = {"affine": layer}
        log.info("nnet-am-limit-rank: %s rank %d/%d (%.1f%% energy)",
                 name, k, full, 100 * kept)
    save_nnet2(args[1], params, cfg, priors)
    return 0


# Port of kaldi_tpu/cli/tools_bank31.py nnet_am_reinitialize_tool.
@tool("nnet-am-reinitialize")
def nnet_am_reinitialize_tool(argv):
    """Re-target a trained net at a NEW transition model's pdf set:
    hidden layers are kept, the output affine is re-initialized at the
    new dimension (nnet2bin/nnet-am-reinitialize.cc — the transfer-
    learning step of the multilingual recipes)."""
    import dataclasses
    from kaldi_tpu_torch.am.nnet2 import (layer_names, load_nnet2_full,
                                          save_nnet2)
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions("nnet-am-reinitialize [opts] <nnet2-in> "
                      "<mdl-with-new-tree> <nnet2-out>")
    po.register("srand", int, 0, "seed for the new output layer")
    args = po.read(argv)
    params, cfg, _priors = load_nnet2_full(args[0])
    tm, _ = read_mdl(args[1], device="cpu")
    new_pdfs = tm.num_pdfs
    params = dict(params)
    rng = np.random.default_rng(po["srand"])
    in_dim = np.asarray(params["output_affine"]["kernel"]).shape[0]
    params["output_affine"] = {
        "kernel": (rng.standard_normal((in_dim, new_pdfs))
                   / np.sqrt(in_dim)).astype(np.float32),
        "bias": np.zeros(new_pdfs, np.float32),
    }
    new_cfg = dataclasses.replace(cfg, num_pdfs=new_pdfs, mix2pdf=None,
                                  learn_rates=None)
    save_nnet2(args[2], params, new_cfg, priors=None)
    log.info("nnet-am-reinitialize: output %d → %d pdfs "
             "(%d hidden layers kept)", cfg.num_pdfs, new_pdfs,
             len(layer_names(cfg)) - 1)
    return 0


# Port of kaldi_tpu/cli/tools_bank31.py nnet_compute_from_egs_tool.
@tool("nnet-compute-from-egs")
def nnet_compute_from_egs_tool(argv):
    """Forward-propagate training examples and write the network's
    log-posterior output per eg (nnet2bin/nnet-compute-from-egs.cc —
    used by the combination/diagnostic scripts), on ``--device``."""
    from kaldi_tpu_torch.cli.tools_bank19 import load_nnet2_scorer
    po = ParseOptions("nnet-compute-from-egs <nnet2-in> <egs-rspec> "
                      "<feats-wspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    model, _cfg, _ = load_nnet2_scorer(args[0], device,
                                       divide_by_priors=False)
    n = 0
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for key, eg in SequentialTableReader(args[1], holder="xeg"):
            x = torch.tensor(np.asarray(eg.feats, np.float32)
                             ).to(device)                   # (B, T, D)
            out = model(x)                                  # (B, T, P)
            w[key] = out.reshape(-1, out.shape[-1]).cpu().numpy()
            n += 1
    log.info("nnet-compute-from-egs: %d egs", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank31.py nnet_modify_learning_rates_tool.
@tool("nnet-modify-learning-rates")
def nnet_modify_learning_rates_tool(argv):
    """Set per-layer learning rates so every layer's RELATIVE
    parameter change (‖θ_cur − θ_prev‖/‖θ_cur‖) would match, with the
    geometric mean pinned to --average-learning-rate
    (nnet2bin/nnet-modify-learning-rates.cc).  The rates ride the
    model file."""
    import dataclasses
    from kaldi_tpu_torch.am.nnet2 import (layer_names, load_nnet2_full,
                                          save_nnet2)
    po = ParseOptions("nnet-modify-learning-rates [opts] "
                      "<prev-nnet2> <cur-nnet2> <nnet2-out>")
    po.register("average-learning-rate", float, 2e-3,
                "geometric-mean target of the per-layer rates")
    po.register("first-layer-factor", float, 1.0,
                "extra scale on layer 0's rate")
    po.register("last-layer-factor", float, 1.0,
                "extra scale on the output layer's rate")
    args = po.read(argv)
    prev, _pcfg, _ = load_nnet2_full(args[0])
    cur, cfg, priors = load_nnet2_full(args[1])
    names = layer_names(cfg)
    rel = []
    for name in names:
        dp, dc = 0.0, 0.0
        for leaf_p, leaf_c in zip(
                _flat_leaves(prev[name]), _flat_leaves(cur[name])):
            dp += float(((leaf_c - leaf_p) ** 2).sum())
            dc += float((leaf_c ** 2).sum())
        rel.append(np.sqrt(dp / max(dc, 1e-20)) + 1e-10)
    rel = np.asarray(rel)
    # lr_i ∝ 1/rel_i equalizes relative change; pin geometric mean
    inv = 1.0 / rel
    lrs = inv * po["average-learning-rate"] / np.exp(
        np.mean(np.log(inv)))
    lrs[0] *= po["first-layer-factor"]
    lrs[-1] *= po["last-layer-factor"]
    new_cfg = dataclasses.replace(cfg,
                                  learn_rates=tuple(float(x) for x in lrs))
    save_nnet2(args[2], cur, new_cfg, priors)
    for name, rc, lr in zip(names, rel, lrs):
        log.info("nnet-modify-learning-rates: %s rel-change %.3e "
                 "→ lr %.3e", name, rc, lr)
    return 0


# ---------------------------------------------------------------------------
# the nnet2 input feature transform
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank31.py nnet_get_feature_transform_tool.
@tool("nnet-get-feature-transform")
def nnet_get_feature_transform_tool(argv):
    """Compute the nnet2 input feature transform from LDA-style stats
    (nnet2bin/nnet-get-feature-transform.cc): a NON-dimension-reducing
    LDA whose within-class variance is scaled by
    --within-class-factor, so directions with low discrimination are
    shrunk rather than dropped."""
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    from kaldi_tpu_torch.cli.tools_bank9 import read_lda_accs
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet-get-feature-transform [opts] <mat-out> "
                      "<lda-acc1> [<lda-acc2> ...]")
    po.register("dim", int, 0, "output dim (0 ⇒ full input dim)")
    po.register("within-class-factor", float, 0.001,
                "scale on the within-class variance")
    args = po.read(argv)
    lda = None
    for acc_path in args[1:]:
        counts, first, second = read_lda_accs(acc_path)
        if lda is None:
            lda = LdaEstimate(len(counts), first.shape[1])
        lda.counts += counts
        lda.first += first
        lda.total_second += second
    if lda is None:
        raise KaldiError("nnet-get-feature-transform: no accs")
    dim = po["dim"] or lda.first.shape[1]
    mat = lda.estimate(dim, within_class_factor=po[
        "within-class-factor"])
    with kio.open_wxfilename(args[0]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, mat.astype(np.float32))
    log.info("nnet-get-feature-transform: %s transform "
             "(within-class-factor %g)", mat.shape,
             po["within-class-factor"])
    return 0


# Copied from kaldi_tpu/cli/tools_bank31.py
# nnet_get_feature_transform_multi_tool.
@tool("nnet-get-feature-transform-multi")
def nnet_get_feature_transform_multi_tool(argv):
    """Block version for multi-context inputs
    (nnet2bin/nnet-get-feature-transform-multi.cc role): the LDA acc
    is over D·N-dim spliced features; --context-groups partitions the
    N context positions (colon-separated groups of comma-separated
    indexes) and one transform is estimated per group on its own
    sub-blocks, stacked block-diagonally."""
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    from kaldi_tpu_torch.cli.tools_bank9 import read_lda_accs
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet-get-feature-transform-multi [opts] "
                      "<lda-acc> <mat-out>")
    po.register("context-groups", str, "", "e.g. 0,1,2:3,4 "
                "(REQUIRED) — groups of context positions")
    po.register("feat-dim", int, 0, "per-context feature dim "
                "(REQUIRED)")
    po.register("within-class-factor", float, 0.001,
                "scale on the within-class variance")
    args = po.read(argv)
    if not po["context-groups"] or po["feat-dim"] <= 0:
        raise KaldiError("nnet-get-feature-transform-multi: "
                         "--context-groups and --feat-dim required")
    D = po["feat-dim"]
    counts, first, second = read_lda_accs(args[0])
    total = first.shape[1]
    if total % D:
        raise KaldiError(f"acc dim {total} not a multiple of "
                         f"--feat-dim {D}")
    groups = [[int(i) for i in g.split(",") if i != ""]
              for g in po["context-groups"].split(":")]
    blocks = []
    for g in groups:
        idx = np.concatenate([np.arange(c * D, (c + 1) * D)
                              for c in g])
        sub = LdaEstimate(len(counts), len(idx))
        sub.counts = counts.copy()
        sub.first = first[:, idx]
        sub.total_second = second[np.ix_(idx, idx)]
        # estimate() appends a mean-offset column; keep the linear part
        mat = sub.estimate(len(idx), within_class_factor=po[
            "within-class-factor"])
        blocks.append((mat, list(idx)))
    out_dim = sum(b.shape[0] for b, _ in blocks)
    full = np.zeros((out_dim, total + 1), np.float64)
    r = 0
    for mat, idx in blocks:
        rows = slice(r, r + mat.shape[0])
        full[rows, -1] = mat[:, -1]            # offset column
        for j, col in enumerate(idx):
            full[rows, col] = mat[:, j]
        r += mat.shape[0]
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, full.astype(np.float32))
    log.info("nnet-get-feature-transform-multi: %d groups → "
             "%s block transform", len(groups), full.shape)
    return 0


# Port of kaldi_tpu/cli/tools_bank31.py nnet_normalize_stddev_tool.
@tool("nnet-normalize-stddev")
def nnet_normalize_stddev_tool(argv):
    """Rescale each hidden affine so its pre-pnorm output stddev over
    a set of egs equals --stddev (nnet2bin/nnet-normalize-stddev.cc), on
    ``--device`` (am/nnet2.py ``normalize_stddev``).  Valid because
    pnorm is scale-equivariant and the following NormalizeComponent
    cancels the scale downstream — only the layer's own dynamic range
    changes, exactly the reference's rationale."""
    from kaldi_tpu_torch.am.nnet2 import (load_nnet2_full,
                                          normalize_stddev, save_nnet2)
    po = ParseOptions("nnet-normalize-stddev [opts] <nnet2-in> "
                      "<egs-rspec> <nnet2-out>")
    po.register("stddev", float, 1.0, "target output stddev")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    params, cfg, priors = load_nnet2_full(args[0])
    xs = [np.asarray(eg.feats, np.float32) for _key, eg in
          SequentialTableReader(args[1], holder="xeg")]
    if not xs:
        raise KaldiError("nnet-normalize-stddev: no egs")
    params, before = normalize_stddev(params, cfg, np.concatenate(xs),
                                      po["stddev"], device)
    for name, sd in before:
        log.info("nnet-normalize-stddev: %s stddev %.3f → %.3f",
                 name, sd, po["stddev"])
    save_nnet2(args[2], params, cfg, priors)
    return 0


# ---------------------------------------------------------------------------
# nnet2 discriminative (sequence) training
# ---------------------------------------------------------------------------

def _disc_po(po: ParseOptions) -> None:
    po.register("criterion", str, "smbr", "smbr|mmi")
    po.register("learning-rate", float, 5e-5, "adam lr")
    po.register("acoustic-scale", float, 0.1, "kappa")
    po.register("num-epochs", int, 2, "epochs over the egs")
    _device_po(po)


def _disc_read(po: ParseOptions, args):
    if po["criterion"] not in ("smbr", "mmi"):
        raise KaldiError(f"unknown criterion {po['criterion']}")
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full
    device = resolve_device(po["device"])
    params, cfg, priors = load_nnet2_full(args[0])
    degs = [eg for _k, eg in SequentialTableReader(args[1],
                                                   holder="deg")]
    return device, params, cfg, priors, degs


# Port of kaldi_tpu/cli/tools_bank31.py
# nnet_train_discriminative_simple_tool.
@tool("nnet-train-discriminative-simple")
def nnet_train_discriminative_simple_tool(argv):
    """MMI/sMBR sequence training of an nnet2 model from
    discriminative egs (nnet2bin/nnet-train-discriminative-simple.cc),
    on ``--device``.  Degs are the same dense-lattice records the nnet3
    pipeline uses (nnet3-discriminative-get-egs)."""
    from kaldi_tpu_torch.am.nnet2 import save_nnet2, train_discriminative
    po = ParseOptions("nnet-train-discriminative-simple [opts] "
                      "<nnet2-in> <degs-rspec> <nnet2-out>")
    _disc_po(po)
    args = po.read(argv)
    device, params, cfg, priors, degs = _disc_read(po, args)
    params, mean_loss = train_discriminative(
        params, cfg, degs, po["criterion"], po["learning-rate"],
        po["acoustic-scale"], po["num-epochs"], device)
    save_nnet2(args[2], params, cfg, priors)
    log.info("nnet-train-discriminative-simple: %d egs, mean "
             "-objf %.4f", len(degs), mean_loss)
    return 0


# Port of kaldi_tpu/cli/tools_bank31.py
# nnet_train_discriminative_parallel_tool.
@tool("nnet-train-discriminative-parallel")
def nnet_train_discriminative_parallel_tool(argv):
    """Parallel variant: the degs are sharded --num-threads ways, each
    shard trains a copy from the common start, and the result is the
    parameter average (nnet2bin/nnet-train-discriminative-parallel.cc
    — its threads update one model without locks; averaging shards
    is the deterministic equivalent of that race), on ``--device``."""
    from kaldi_tpu_torch.am.nnet2 import (save_nnet2,
                                          train_discriminative_parallel)
    po = ParseOptions("nnet-train-discriminative-parallel [opts] "
                      "<nnet2-in> <degs-rspec> <nnet2-out>")
    _disc_po(po)
    po.register("num-threads", int, 2, "shards to train + average")
    args = po.read(argv)
    device, params, cfg, priors, degs = _disc_read(po, args)
    avg, loss, N = train_discriminative_parallel(
        params, cfg, degs, po["num-threads"], po["criterion"],
        po["learning-rate"], po["acoustic-scale"], po["num-epochs"],
        device)
    save_nnet2(args[2], avg, cfg, priors)
    log.info("nnet-train-discriminative-parallel: %d egs over %d "
             "shards, mean -objf %.4f", len(degs), N, loss)
    return 0
