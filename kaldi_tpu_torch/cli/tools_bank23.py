"""Port of kaldi_tpu/cli/tools_bank23.py's chain egs and model tails
(nnet3-chain-merge-egs, -normalize-egs, -combine, -compute-post,
nnet3-am-adjust-priors) and its discriminative egs tail
(nnet3-discriminative-merge-egs, -subset-egs, -compute-from-egs; parity
targets chainbin/ and nnet3bin/ of the same names), registered in
cli/tools.py's ``TOOLS``.  The egs tools and nnet3-am-adjust-priors are
the original's host code, copied.  nnet3-chain-combine,
-compute-post and -discriminative-compute-from-egs take ``--device``
(default cuda) and run the raw TDNN-F's forward there; -combine's
objective runs the den kernel (am/chain.py) and optax's Adam over the
combination logits (pipelines/chain.py ``combine_models``).
nnet3-compute-batch (nnet3bin/nnet3-compute-batch.cc) runs the TDNN-F
of a raw model or a .mdl on ``--device``, a batch at a time.
nnet3-chain-acc-lda-stats, nnet3-am-init and nnet3-am-train-transitions
(chainbin/nnet3-chain-acc-lda-stats.cc, nnet3bin/nnet3-am-init.cc,
nnet3-am-train-transitions.cc) are the original's host code, copied:
their files are the original's bytes.
"""

from __future__ import annotations

import io as pio
from typing import Dict, List

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

_TM_END = b"</TransitionModel>"


# Copied from kaldi_tpu/cli/tools_bank23.py _split_mdl.
def _split_mdl(path: str):
    """nnet3 .mdl → (tm blob incl. end tag, nnet blob).  The priors
    marker (see nnet3-am-adjust-priors) is stripped from the nnet
    blob."""
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: not binary kaldi")
        head = f.read()
    pos = head.find(_TM_END)
    tm_blob = head[:pos + len(_TM_END)] if pos >= 0 else b""
    nnet_blob = head[pos + len(_TM_END):] if pos >= 0 else head
    pmark = nnet_blob.find(b"<KTPriors>")
    priors = None
    if pmark >= 0:
        from kaldi_tpu_torch.core import io as kio
        buf = pio.BytesIO(nnet_blob[pmark:])
        kio.expect_token(buf, "<KTPriors>")
        priors = np.asarray(kio.read_vector(buf))
        nnet_blob = nnet_blob[:pmark]
    return tm_blob, nnet_blob, priors


# Copied from kaldi_tpu/cli/tools_bank23.py _write_mdl_blobs.
def _write_mdl_blobs(path: str, tm_blob: bytes, nnet_blob: bytes,
                     priors=None) -> None:
    from kaldi_tpu_torch.core import io as kio
    with open(path, "wb") as f:
        f.write(b"\0B")
        f.write(tm_blob)
        f.write(nnet_blob)
        if priors is not None:
            kio.write_token(f, "<KTPriors>")
            kio.write_vector(f, np.asarray(priors, np.float64))


# ---------------------------------------------------------------------------
# chainbin egs tail
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_chain_merge_egs_tool.
@tool("nnet3-chain-merge-egs")
def nnet3_chain_merge_egs_tool(argv):
    """Group chain egs into same-shape minibatches
    (chainbin/nnet3-chain-merge-egs.cc): downstream trainers batch
    consecutive entries, so this sorts by shape and renames keys
    mb<i>-<j>; shapes with fewer than --minibatch-size entries are
    kept as a short final minibatch unless --discard-partial=true."""
    po = ParseOptions("nnet3-chain-merge-egs [opts] <egs-rspec> "
                      "<egs-wspec>")
    po.register("minibatch-size", int, 16, "chunks per minibatch")
    po.register("discard-partial", bool, False,
                "drop trailing partial minibatches")
    args = po.read(argv)
    B = max(1, po["minibatch-size"])
    groups: Dict[tuple, List] = {}
    for key, eg in SequentialTableReader(args[0], holder="ceg"):
        groups.setdefault(eg.feats.shape, []).append((key, eg))
    n_out = n_drop = mb = 0
    with TableWriter(args[1], holder="ceg") as w:
        for shape in sorted(groups):
            entries = groups[shape]
            for i in range(0, len(entries), B):
                chunk = entries[i:i + B]
                if len(chunk) < B and po["discard-partial"]:
                    n_drop += len(chunk)
                    continue
                for j, (_k, eg) in enumerate(chunk):
                    w[f"mb{mb}-{j}"] = eg
                    n_out += 1
                mb += 1
    log.info("nnet3-chain-merge-egs: %d egs → %d minibatches "
             "(%d discarded)", n_out + n_drop, mb, n_drop)
    return 0


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_chain_normalize_egs_tool.
@tool("nnet3-chain-normalize-egs")
def nnet3_chain_normalize_egs_tool(argv):
    """(Re-)apply denominator-graph normalization weights to chain
    egs (chainbin/nnet3-chain-normalize-egs.cc composes the
    normalization FST into the supervision; here the weights are
    recomputed from the den graph along each eg's segment chain,
    with chunk-local phone history — the same approximation the
    reference's per-chunk composition makes)."""
    from kaldi_tpu_torch.am.chain import read_denominator_graph
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet3-chain-normalize-egs <trans-model> "
                      "<den-graph> <egs-rspec> <egs-wspec>")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    with kio.open_rxfilename(args[1]) as f:
        kio.init_kaldi_input_stream(f)
        den = read_denominator_graph(f)
    # entry pdf → phone (chain trees: the forward pdf identifies the
    # phone for each left-context class; collisions are rejected)
    pdf_info = tm.tree.get_pdf_info(tm.topo)
    entry_phone = {}
    for pdf, pairs in enumerate(pdf_info):
        phones = {ph for ph, _pc in pairs}
        if len(phones) == 1:
            entry_phone[pdf] = phones.pop()
    lm = den.lm
    n = n_skip = 0
    with TableWriter(args[3], holder="ceg") as w:
        for key, eg in SequentialTableReader(args[2], holder="ceg"):
            if eg.entry_pdf is None:
                n_skip += 1
                w[key] = eg
                continue
            try:
                segs = [entry_phone[int(p)] for p in eg.entry_pdf]
            except KeyError:
                raise KaldiError("nnet3-chain-normalize-egs: entry pdf"
                                 " does not identify a unique phone — "
                                 "tree not chain-compatible")
            # the make_chain_egs norm_weights recursion with
            # chunk-local history (state of the chunk's first phone)
            S_out = len(eg.entry_w)
            segs = segs[:S_out]
            ew = np.zeros(S_out, np.float32)
            sw = np.zeros(S_out, np.float32)
            nv_init, nv_self, nv_fwd, nv_final = den.norm_view()
            st = lm.state_of((segs[0],))
            eg.init_w = float(den.initial_for((segs[0],)))
            sw[0] = nv_self[st]
            for i in range(1, len(segs)):
                c = lm.phones.index(segs[i])
                ew[i] = nv_fwd[st] + lm.next_logp[st, c]
                st = int(lm.next_state[st, c])
                sw[i] = nv_self[st]
            eg.entry_w = ew
            eg.self_w = sw
            eg.final_w = float(nv_final[st])
            w[key] = eg
            n += 1
    log.info("nnet3-chain-normalize-egs: %d normalized, %d without "
             "segments", n, n_skip)
    return 0


# Port of kaldi_tpu/cli/tools_bank23.py nnet3_chain_combine_tool.
@tool("nnet3-chain-combine")
def nnet3_chain_combine_tool(argv):
    """Combine raw chain models by objective-optimized weights on
    validation chain egs (chainbin/nnet3-chain-combine.cc; adam over
    the combination logits, LF-MMI objective; pipelines/chain.py
    ``combine_models``).  The mixed models' forward and the objective,
    with the den kernel, run on ``--device``; each iteration's loss and
    gradient on the logits, and the den kernel's launches, are
    logged."""
    from kaldi_tpu_torch.am.chain import read_denominator_graph
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines.chain import combine_models
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    po = ParseOptions("nnet3-chain-combine [opts] <den-graph> "
                      "<valid-egs-rspec> <raw-in1> [<raw-in2> ...] "
                      "<raw-out>")
    po.register("num-iters", int, 30, "weight-optimization steps")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    _device_po(po)
    args = po.read(argv)
    if len(args) < 4:
        raise KaldiError("nnet3-chain-combine: need >=1 input model")
    device = resolve_device(po["device"])
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        den = read_denominator_graph(f)
    model_paths, out_path = args[2:-1], args[-1]
    loaded = [_read_raw_auto(p, device, po["frame-subsampling-factor"])
              for p in model_paths]
    before = CudaChainDen.total_launches
    trace = []
    sd, wgt, objf = combine_models([net for net, _c in loaded], den,
                                   read_egs_ark(args[1]), po["num-iters"],
                                   trace=trace)
    for i, (loss, g) in enumerate(trace):
        log.info("nnet3-chain-combine: iteration %d: loss %.9g, gradient "
                 "on the logits %s", i, loss,
                 " ".join(f"{x:.9g}" for x in g))
    write_raw_model(out_path, sd, loaded[0][1])
    log.info("nnet3-chain-combine: %d models, weights %s, objf %.4f",
             len(loaded), np.round(wgt, 3), objf)
    log.info("nnet3-chain-combine: den kernel launches %d",
             CudaChainDen.total_launches - before)
    return 0


# Port of kaldi_tpu/cli/tools_bank23.py nnet3_chain_compute_post_tool.
@tool("nnet3-chain-compute-post")
def nnet3_chain_compute_post_tool(argv):
    """Per-frame pdf posteriors from a chain model over egs
    (chainbin/nnet3-chain-compute-post.cc: softmax of the chain
    output — used for silence-probability estimation and biased-LM
    cleanup); the forward and softmax on ``--device``."""
    po = ParseOptions("nnet3-chain-compute-post [opts] <raw-model> "
                      "<feats-rspec> <post-wspec>")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    net, _cfg = _read_raw_auto(args[0], device,
                               po["frame-subsampling-factor"])
    n = 0
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            post = torch.softmax(net(x[None])[0], dim=-1)
            w[key] = post.cpu().numpy().astype(np.float32)
            n += 1
    log.info("nnet3-chain-compute-post: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# nnet3bin model-utility tail
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_am_adjust_priors_tool.
@tool("nnet3-am-adjust-priors")
def nnet3_am_adjust_priors_tool(argv):
    """Attach pdf priors (from pdf-to-counts) to an nnet3 .mdl
    (nnet3bin/nnet3-am-adjust-priors.cc; priors ride a trailing
    framed section and nnet3-compute-batch subtracts log-priors when
    present)."""
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet3-am-adjust-priors <mdl-in> "
                      "<counts-rxfilename> <mdl-out>")
    args = po.read(argv)
    tm_blob, nnet_blob, _old = _split_mdl(args[0])
    with kio.open_rxfilename(args[1]) as f:
        kio.init_kaldi_input_stream(f)
        counts = np.asarray(kio.read_vector(f), np.float64)
    priors = (counts + 0.5) / (counts.sum() + 0.5 * len(counts))
    _write_mdl_blobs(args[2], tm_blob, nnet_blob, priors=priors)
    log.info("nnet3-am-adjust-priors: %d pdfs, entropy %.3f",
             len(priors), -float((priors * np.log(priors)).sum()))
    return 0


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_am_init_tool.
@tool("nnet3-am-init")
def nnet3_am_init_tool(argv):
    """Transition model + raw nnet → .mdl
    (nnet3bin/nnet3-am-init.cc)."""
    po = ParseOptions("nnet3-am-init <trans-model-mdl> <raw-in> "
                      "<mdl-out>\n<trans-model-mdl> may be any .mdl "
                      "whose TransitionModel should be reused")
    args = po.read(argv)
    tm_blob, _n, _p = _split_mdl(args[0])
    if not tm_blob:
        raise KaldiError(f"{args[0]}: no <TransitionModel> section")
    with open(args[1], "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{args[1]}: not binary kaldi")
        nnet_blob = f.read()
    _write_mdl_blobs(args[2], tm_blob, nnet_blob)
    log.info("nnet3-am-init: wrote %s", args[2])
    return 0


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_am_train_transitions_tool.
@tool("nnet3-am-train-transitions")
def nnet3_am_train_transitions_tool(argv):
    """Re-estimate transition probabilities from alignments
    (nnet3bin/nnet3-am-train-transitions.cc)."""
    from kaldi_tpu_torch.am.serialize import (read_transition_model,
                                              write_transition_model)
    po = ParseOptions("nnet3-am-train-transitions <mdl-in> <ali-rspec> "
                      "<mdl-out>")
    args = po.read(argv)
    tm_blob, nnet_blob, priors = _split_mdl(args[0])
    tm = read_transition_model(pio.BytesIO(tm_blob))
    counts = np.zeros(tm.num_transition_ids + 1)
    n = 0
    for _key, ali in SequentialTableReader(args[1], holder="ivec"):
        np.add.at(counts, np.asarray(ali, np.int64), 1.0)
        n += 1
    tm.mle_update(counts)
    buf = pio.BytesIO()
    write_transition_model(buf, tm)
    _write_mdl_blobs(args[2], buf.getvalue(), nnet_blob,
                     priors=priors)
    log.info("nnet3-am-train-transitions: %d alignments", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_chain_acc_lda_stats_tool.
@tool("nnet3-chain-acc-lda-stats")
def nnet3_chain_acc_lda_stats_tool(argv):
    """LDA stats from chain egs (chainbin/nnet3-chain-acc-lda-stats.cc
    — the LDA-like preconditioning transform at the network input):
    class = the eg's numerator pdf at each subsampled frame, sample =
    the frame's input features."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    from kaldi_tpu_torch.cli.tools_bank16 import write_lda_accs
    po = ParseOptions("nnet3-chain-acc-lda-stats <trans-model> "
                      "<egs-rspec> <lda-accs-out>")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    lda = None
    n = 0
    for _key, eg in SequentialTableReader(args[1], holder="ceg"):
        sub = max(1, eg.feats.shape[0] // max(len(eg.pdf_ali), 1))
        if lda is None:
            lda = LdaEstimate(tm.num_pdfs, eg.feats.shape[1])
        t_idx = np.minimum(np.arange(len(eg.pdf_ali)) * sub,
                           eg.feats.shape[0] - 1)
        mask = eg.mask.astype(bool)
        lda.accumulate_batch(np.asarray(eg.feats)[t_idx][mask],
                             np.asarray(eg.pdf_ali)[mask])
        n += 1
    if lda is None:
        raise KaldiError("nnet3-chain-acc-lda-stats: no egs")
    write_lda_accs(args[2], lda)
    log.info("nnet3-chain-acc-lda-stats: %d egs", n)
    return 0


# ---------------------------------------------------------------------------
# the discriminative egs tail
# ---------------------------------------------------------------------------


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_discriminative_merge_egs_tool.
@tool("nnet3-discriminative-merge-egs")
def nnet3_discriminative_merge_egs_tool(argv):
    """Group discriminative egs into same-shape minibatches
    (nnet3bin/nnet3-discriminative-merge-egs.cc; key-renaming
    convention as nnet3-chain-merge-egs)."""
    po = ParseOptions("nnet3-discriminative-merge-egs [opts] "
                      "<egs-rspec> <egs-wspec>")
    po.register("minibatch-size", int, 8, "egs per minibatch")
    args = po.read(argv)
    B = max(1, po["minibatch-size"])
    groups: Dict[tuple, List] = {}
    for key, eg in SequentialTableReader(args[0], holder="deg"):
        groups.setdefault(eg.feats.shape, []).append(eg)
    n = mb = 0
    with TableWriter(args[1], holder="deg") as w:
        for shape in sorted(groups):
            for i in range(0, len(groups[shape]), B):
                for j, eg in enumerate(groups[shape][i:i + B]):
                    w[f"mb{mb}-{j}"] = eg
                    n += 1
                mb += 1
    log.info("nnet3-discriminative-merge-egs: %d egs → %d "
             "minibatches", n, mb)
    return 0


# Copied from kaldi_tpu/cli/tools_bank23.py nnet3_discriminative_subset_egs_tool.
@tool("nnet3-discriminative-subset-egs")
def nnet3_discriminative_subset_egs_tool(argv):
    po = ParseOptions("nnet3-discriminative-subset-egs [--n=10] "
                      "<egs-rspec> <egs-wspec>")
    po.register("n", int, 10, "keep first n")
    args = po.read(argv)
    n = 0
    with TableWriter(args[1], holder="deg") as w:
        for key, eg in SequentialTableReader(args[0], holder="deg"):
            if n >= po["n"]:
                break
            w[key] = eg
            n += 1
    log.info("nnet3-discriminative-subset-egs: kept %d", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank23.py nnet3_discriminative_compute_from_egs_tool.
@tool("nnet3-discriminative-compute-from-egs")
def nnet3_discriminative_compute_from_egs_tool(argv):
    """Forward discriminative egs through a raw model and write the
    per-frame output (nnet3bin/nnet3-discriminative-compute-from-
    egs.cc)."""
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
    po = ParseOptions("nnet3-discriminative-compute-from-egs "
                      "<raw-model> <egs-rspec> <mat-wspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    net, _cfg = _read_raw_auto(args[0], device)
    n = 0
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for key, eg in SequentialTableReader(args[1], holder="deg"):
            x = torch.as_tensor(np.asarray(eg.feats, np.float32)).to(device)
            w[key] = net(x[None])[0].cpu().numpy().astype(np.float32)
            n += 1
    log.info("nnet3-discriminative-compute-from-egs: %d egs", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank23.py nnet3_compute_batch_tool.
@tool("nnet3-compute-batch")
def nnet3_compute_batch_tool(argv):
    """Batched nnet3 forward (nnet3bin/nnet3-compute-batch.cc): pads
    utterances, sorted by length, to one (B, T) shape per batch, a
    multiple of ``--bucket`` frames, with zero frames, as the original
    does; subtracts log-priors when the model carries them.  The TDNN-F
    clamps its splices at the padded end, so the last frames of an
    utterance shorter than its batch see the zeros, as in the
    original."""
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict, read_nnet3)
    from kaldi_tpu_torch.am.tdnn import TdnnChain
    po = ParseOptions("nnet3-compute-batch [opts] <model> "
                      "<feats-rspec> <mat-wspec>\n<model> may be raw "
                      "or .mdl (with optional priors)")
    po.register("batch-size", int, 8, "utterances per device batch")
    po.register("bucket", int, 64, "frame-count padding multiple")
    po.register("frame-subsampling-factor", int, 1, "subsampling")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    # _split_mdl handles both forms: a raw model has no
    # <TransitionModel> section, so the whole file is the nnet blob
    _tm_blob, nnet_blob, priors = _split_mdl(args[0])
    model = read_nnet3(pio.BytesIO(nnet_blob))
    cfg = infer_tdnn_config(
        model, frame_subsampling_factor=po["frame-subsampling-factor"])
    net = TdnnChain(cfg)
    net.load_state_dict(nnet3_to_state_dict(model, cfg))
    net = net.eval().to(device)
    log_priors = (torch.as_tensor(np.log(np.maximum(priors, 1e-20)),
                                  dtype=torch.float32).to(device)
                  if priors is not None else None)
    B = max(1, po["batch-size"])
    bucket = max(1, po["bucket"])
    entries = list(SequentialTableReader(args[1], holder="mat"))
    entries.sort(key=lambda kv: (len(kv[1]), kv[0]))
    sub = cfg.frame_subsampling_factor
    n = 0
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for i in range(0, len(entries), B):
            chunk = entries[i:i + B]
            T_pad = -(-max(len(m) for _k, m in chunk) // bucket) * bucket
            D = chunk[0][1].shape[1]
            Xb = np.zeros((B, T_pad, D), np.float32)
            for b, (_k, m) in enumerate(chunk):
                Xb[b, :len(m)] = m
            out = net(torch.from_numpy(Xb).to(device))
            for b, (k, m) in enumerate(chunk):
                rows = out[b, :max(1, len(m) // sub)]
                if log_priors is not None:
                    rows = rows - log_priors[None, :]
                w[k] = rows.cpu().numpy()
                n += 1
    log.info("nnet3-compute-batch: %d utterances", n)
    return 0
