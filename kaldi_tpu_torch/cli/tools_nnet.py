# Port of kaldi_tpu/cli/tools_bank6.py, tools_bank9.py, tools_bank16.py and tools_bank29.py (five tools).
"""xconfig, cross-entropy training and x-vector tools (nnet3bin/).

Port of ``xconfig-to-configs`` (kaldi_tpu/cli/tools_bank6.py),
``nnet3-train`` (tools_bank9.py), ``nnet3-xvector-get-egs`` and
``nnet3-xvector-compute`` (tools_bank16.py) and
``nnet3-xvector-compute-batched`` (tools_bank29.py), registered in
cli/tools.py's ``TOOLS``.  Each keeps the original's options, arguments
and files; those that compute with a model add ``--device`` (default
cuda).  ``xconfig-to-configs`` takes a ``stats-layer``'s width from its
input descriptor (the original takes the width of the line before it,
which differs whenever ``input=`` names another layer).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank6.py xconfig_to_configs_tool.
@tool("xconfig-to-configs")
def xconfig_to_configs_tool(argv):
    """Validate an xconfig file and report per-layer output dims.

    Usage: xconfig-to-configs --xconfig-file=<f> --config-dir=<dir>
    Writes <dir>/final.xconfig (the canonical copy recipes load) and
    <dir>/network.txt (layer table); prints the table to stderr."""
    from kaldi_tpu_torch.am.xconfig import layer_widths, model_from_xconfig
    po = ParseOptions(
        "xconfig-to-configs --xconfig-file=<file> --config-dir=<dir>")
    po.register("xconfig-file", str, "", "input xconfig file")
    po.register("config-dir", str, "", "output directory")
    po.register("frame-subsampling-factor", int, 1,
                "time subsampling before output layers (chain ×3)")
    po.read(argv)
    if not po["xconfig-file"] or not po["config-dir"]:
        po.print_usage()
        return 1
    with open(po["xconfig-file"]) as f:
        text = f.read()
    # building the model validates it and counts its parameters (batch
    # statistics included, as flax's variables hold them)
    model, in_dim, out_dims = model_from_xconfig(
        text, frame_subsampling_factor=po["frame-subsampling-factor"])
    lines = model.xlines
    dims = layer_widths(lines)
    os.makedirs(po["config-dir"], exist_ok=True)
    with open(os.path.join(po["config-dir"], "final.xconfig"), "w") as f:
        f.write(text)
    rows = ["# name type dim"]
    for line in lines:
        rows.append(f"{line.name} {line.layer_type} {dims[line.name]}")
    with open(os.path.join(po["config-dir"], "network.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    num_params = sum(v.numel() for v in model.state_dict().values())
    for r in rows:
        log.info("%s", r)
    log.info("xconfig-to-configs: %d layers, %d parameters, outputs %s",
             len(lines), num_params, out_dims)
    return 0


# Port of kaldi_tpu/cli/tools_bank9.py nnet3_train.
@tool("nnet3-train")
def nnet3_train(argv):
    """Cross-entropy training from feats + pdf alignments
    (nnet3bin/nnet3-train.cc role; egs inlined as feats+ali tables)."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.pipelines.nnet import XentTrainConfig, XentTrainer
    po = ParseOptions("nnet3-train [opts] <feats-rspec> <pdf-ali-rspec> "
                      "<raw-out>")
    po.register("num-pdfs", int, 0, "output dim (required)")
    po.register("hidden-dim", int, 256, "hidden layer dim")
    po.register("bottleneck-dim", int, 64, "TDNN-F bottleneck dim")
    po.register("num-layers", int, 5, "TDNN-F layers")
    po.register("num-epochs", int, 4, "training epochs")
    po.register("learning-rate", float, 1e-3, "adam lr")
    _device_po(po)
    args = po.read(argv)
    if po["num-pdfs"] <= 0:
        raise KaldiError("nnet3-train: --num-pdfs is required")
    device = resolve_device(po["device"])
    alis = RandomAccessTableReader(args[1], holder="ivec")
    feats, pdf_ali = {}, {}
    for key, f in SequentialTableReader(args[0], holder="mat"):
        if key in alis:
            feats[key] = np.asarray(f)
            pdf_ali[key] = np.asarray(alis[key], np.int32)
    if not feats:
        raise KaldiError("nnet3-train: no matched utterances")
    dim = next(iter(feats.values())).shape[1]
    cfg = TdnnConfig(feat_dim=dim, num_pdfs=po["num-pdfs"],
                     hidden_dim=po["hidden-dim"],
                     bottleneck_dim=po["bottleneck-dim"],
                     num_layers=po["num-layers"],
                     frame_subsampling_factor=1)
    tr = XentTrainer(cfg, XentTrainConfig(
        num_epochs=po["num-epochs"], learning_rate=po["learning-rate"]),
        device=device)
    stats = tr.train(feats, pdf_ali)
    write_raw_model(args[2], tr.model.state_dict(), cfg)
    log.info("nnet3-train: %s", stats)
    return 0


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_xvector_get_egs_tool.
@tool("nnet3-xvector-get-egs")
def nnet3_xvector_get_egs_tool(argv):
    """Fixed-length speaker-labeled chunks for x-vector training
    (nnet3bin/nnet3-xvector-get-egs.cc); labels are speaker indices in
    the sorted speaker list (written with --spk-list)."""
    from kaldi_tpu_torch.pipelines.egs_io import XentEg
    po = ParseOptions("nnet3-xvector-get-egs [opts] <feats-rspec> "
                      "<utt2spk-rspec> <egs-wspec>")
    po.register("chunk-size", int, 64, "frames per chunk")
    po.register("spk-list", str, "", "write speaker list (one/line)")
    args = po.read(argv)
    u2s = {k: v[0] for k, v in
           SequentialTableReader(args[1], holder="text")}
    spks = sorted(set(u2s.values()))
    spk_id = {s: i for i, s in enumerate(spks)}
    T = po["chunk-size"]
    n = 0
    with TableWriter(args[2], holder="xeg") as w:
        for key, feats in SequentialTableReader(args[0], holder="mat"):
            if key not in u2s:
                continue
            feats = np.asarray(feats, np.float32)
            sid = spk_id[u2s[key]]
            for i in range(len(feats) // T):
                chunk = feats[i * T:(i + 1) * T]
                w[f"{key}-{i}"] = XentEg(
                    feats=chunk[None],
                    pdfs=np.full((1, T), sid, np.int32))
                n += 1
    if po["spk-list"]:
        with open(po["spk-list"], "w") as f:
            f.write("\n".join(spks) + "\n")
    log.info("nnet3-xvector-get-egs: %d chunks, %d speakers", n,
             len(spks))
    return 0


# Port of kaldi_tpu/cli/tools_bank16.py nnet3_xvector_compute_tool.
@tool("nnet3-xvector-compute")
def nnet3_xvector_compute_tool(argv):
    """Extract x-vector embeddings for whole utterances
    (nnet3bin/nnet3-xvector-compute.cc)."""
    from kaldi_tpu_torch.am.xvector import (extract_xvector,
                                            load_xvector_model)
    po = ParseOptions("nnet3-xvector-compute <model-in> <feats-rspec> "
                      "<vec-wspec>")
    _device_po(po)
    args = po.read(argv)
    model, _spks = load_xvector_model(args[0], device=po["device"])
    n = 0
    with TableWriter(args[2], holder="vec") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            w[key] = extract_xvector(model, np.asarray(feats, np.float32))
            n += 1
    log.info("nnet3-xvector-compute: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank29.py nnet3_xvector_compute_batched_tool.
@tool("nnet3-xvector-compute-batched")
def nnet3_xvector_compute_batched_tool(argv):
    """Batched x-vector extraction
    (nnet3bin/nnet3-xvector-compute-batched.cc contract): utterances
    are cut into fixed --chunk-size windows, windows from all
    utterances fill fixed-shape device batches, and each utterance's
    embedding is the mean of its chunk embeddings."""
    from kaldi_tpu_torch.am.xvector import load_xvector_model
    po = ParseOptions("nnet3-xvector-compute-batched [opts] "
                      "<model-in> <feats-rspec> <vec-wspec>")
    po.register("batch-size", int, 8, "windows per device batch")
    po.register("chunk-size", int, 100, "frames per window")
    _device_po(po)
    args = po.read(argv)
    model, _spks = load_xvector_model(args[0], device=po["device"])
    dev = model.output.weight.device
    C = po["chunk-size"]
    windows: List[Tuple[str, np.ndarray]] = []
    for key, m in SequentialTableReader(args[1], holder="mat"):
        m = np.asarray(m, np.float32)
        if len(m) <= C:
            win = np.zeros((C, m.shape[1]), np.float32)
            win[:len(m)] = m
            windows.append((key, win))
        else:
            for lo in range(0, len(m) - C + 1, C):
                windows.append((key, m[lo:lo + C]))
    if not windows:
        raise KaldiError("nnet3-xvector-compute-batched: no "
                         "utterances")
    sums: Dict[str, np.ndarray] = {}
    counts: Dict[str, int] = {}
    B = po["batch-size"]
    for i in range(0, len(windows), B):
        chunk = windows[i:i + B]
        X = np.zeros((B, C, chunk[0][1].shape[1]), np.float32)
        for b, (_k, win) in enumerate(chunk):
            X[b] = win
        with torch.no_grad():
            embs = model(torch.from_numpy(X).to(dev),
                         return_embedding=True).cpu().numpy()
        for b, (k, _win) in enumerate(chunk):
            sums[k] = sums.get(k, 0.0) + embs[b]
            counts[k] = counts.get(k, 0) + 1
    n = 0
    with TableWriter(args[2], holder="vec") as w:
        for k in sums:
            w[k] = (sums[k] / counts[k]).astype(np.float32)
            n += 1
    log.info("nnet3-xvector-compute-batched: %d utterances, %d "
             "windows", n, len(windows))
    return 0
