"""Port of the nnet2 model, raw-net and decode tools of
kaldi_tpu/cli/tools_bank26.py (parity targets nnet2bin/{nnet-init,
nnet-to-raw-nnet, nnet1-to-raw-nnet, raw-nnet-copy, raw-nnet-info,
raw-nnet-concat, nnet-am-compute, nnet-compute-prob, nnet-show-progress,
nnet-train-transitions, nnet-adjust-priors, nnet-insert,
nnet-replace-last-layers, nnet-am-widen, nnet-am-mixup,
nnet-am-switch-preconditioning, nnet-align-compiled,
nnet-latgen-faster-parallel}.cc), registered in cli/tools.py's
``TOOLS``.

Models keep the repo convention of storing the TransitionModel in its
own file (upstream bundles it into the am-nnet .mdl); tools that
upstream runs on the bundle take the two paths explicitly.  The model
tools are host numpy on flax's parameter tree (am/nnet2.py, draws from
``np.random.default_rng(srand)`` in the original's order, so their files
equal the original's); nnet-init and nnet-replace-last-layers draw
flax's initializers' distributions from a ``torch.Generator(srand)``.
The tools that run the network, the aligner or the decoder take
``--device`` (default cuda).

Ported to intent, not as they are:
* nnet-align-compiled and nnet-latgen-faster-parallel subtract the
  model's log-priors when its file has them (the original's
  -parallel reads through ``load_nnet2``, which drops ``<Priors>``).
* nnet-latgen-faster-parallel gives each of its threads a decoder of
  its own (the original shares one); the network is shared.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.cli.tools_bank19 import (_latgen_po, latgen_decoder,
                                              latgen_inputs,
                                              load_nnet2_scorer,
                                              nnet2_scores)
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank26.py _read_priors_vec.
def _read_priors_vec(rxfilename: str) -> np.ndarray:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(rxfilename) as f:
        kio.init_kaldi_input_stream(f)
        return np.asarray(kio.read_vector(f), np.float64)


# ---------------------------------------------------------------------------
# raw nets
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank26.py nnet_init_tool.
@tool("nnet-init")
def nnet_init_tool(argv):
    """Random-init a raw nnet2 p-norm net from a config file
    (nnet2bin/nnet-init.cc; config = the steps/nnet2 'key = value'
    lines: feat-dim, num-pdfs, num-hidden-layers, pnorm-input-dim,
    pnorm-output-dim, splice)."""
    from kaldi_tpu_torch.am.nnet2 import Nnet2Config, init_nnet2
    from kaldi_tpu_torch.am.raw_nnet import from_nnet2, save_raw_nnet
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet-init [--srand=0] <config-rxfilename> "
                      "<raw-nnet-out>")
    po.register("srand", int, 0, "init seed")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        text = f.read().decode()
    kv: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise KaldiError(f"nnet-init: bad config line {line!r}")
        k, v = line.split("=", 1)
        kv[k.strip().replace("_", "-")] = v.strip()
    for k in ("feat-dim", "num-pdfs"):
        if k not in kv:
            raise KaldiError(f"nnet-init: config missing {k}")
    splice = tuple(int(x) for x in
                   kv.get("splice", "-2 -1 0 1 2").split())
    cfg = Nnet2Config(
        feat_dim=int(kv["feat-dim"]), num_pdfs=int(kv["num-pdfs"]),
        num_hidden_layers=int(kv.get("num-hidden-layers", "3")),
        pnorm_input_dim=int(kv.get("pnorm-input-dim", "160")),
        pnorm_output_dim=int(kv.get("pnorm-output-dim", "32")),
        splice=splice)
    params = init_nnet2(cfg, torch.Generator().manual_seed(po["srand"]))
    save_raw_nnet(args[1], from_nnet2(params, cfg))
    log.info("nnet-init: %d → %d layers of pnorm(%d→%d) → %d",
             cfg.feat_dim, cfg.num_hidden_layers, cfg.pnorm_input_dim,
             cfg.pnorm_output_dim, cfg.num_pdfs)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_to_raw_nnet_tool.
@tool("nnet-to-raw-nnet")
def nnet_to_raw_nnet_tool(argv):
    """Strip an nnet2 model to its raw component stack
    (nnet2bin/nnet-to-raw-nnet.cc: drops the am-level priors)."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2
    from kaldi_tpu_torch.am.raw_nnet import from_nnet2, save_raw_nnet
    po = ParseOptions("nnet-to-raw-nnet <nnet2-in> <raw-nnet-out>")
    args = po.read(argv)
    params, cfg = load_nnet2(args[0])
    if cfg.mix2pdf is not None:
        raise KaldiError("nnet-to-raw-nnet: mixed-up models have no "
                         "raw component equivalent")
    comps = from_nnet2(params, cfg)
    save_raw_nnet(args[1], comps)
    log.info("nnet-to-raw-nnet: %d components", len(comps))
    return 0


# Copied from kaldi_tpu/cli/tools_bank26.py nnet1_to_raw_nnet_tool.
@tool("nnet1-to-raw-nnet")
def nnet1_to_raw_nnet_tool(argv):
    """Convert an nnet1 sigmoid DNN to a raw component stack
    (nnet2bin/nnet1-to-raw-nnet.cc — the cross-framework bridge)."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1
    from kaldi_tpu_torch.am.raw_nnet import from_nnet1, save_raw_nnet
    po = ParseOptions("nnet1-to-raw-nnet <nnet1-in> <raw-nnet-out>")
    args = po.read(argv)
    params, hid_dims, num_pdfs, _priors = load_nnet1(args[0])
    comps = from_nnet1(params, hid_dims, num_pdfs)
    save_raw_nnet(args[1], comps)
    log.info("nnet1-to-raw-nnet: %d components", len(comps))
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py raw_nnet_copy_tool.
@tool("raw-nnet-copy")
def raw_nnet_copy_tool(argv):
    """Copy a raw net, optionally truncating to the first
    --truncate components (nnet2bin/raw-nnet-copy.cc role)."""
    from kaldi_tpu_torch.am.raw_nnet import load_raw_nnet, save_raw_nnet
    po = ParseOptions("raw-nnet-copy [--truncate=-1] <raw-in> "
                      "<raw-out>")
    po.register("truncate", int, -1,
                "keep only the first N components (-1 = all)")
    args = po.read(argv)
    comps = load_raw_nnet(args[0])
    if po["truncate"] >= 0:
        comps = comps[:po["truncate"]]
    save_raw_nnet(args[1], comps)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py raw_nnet_info_tool.
@tool("raw-nnet-info")
def raw_nnet_info_tool(argv):
    """Print raw-net component structure
    (nnet2bin/raw-nnet-info.cc)."""
    from kaldi_tpu_torch.am.raw_nnet import component_dims, load_raw_nnet
    po = ParseOptions("raw-nnet-info <raw-in>")
    args = po.read(argv)
    comps = load_raw_nnet(args[0])
    print(f"num-components {len(comps)}")
    n_params = 0
    for i, (ctype, params) in enumerate(comps):
        din, dout = component_dims((ctype, params))
        extra = ""
        if ctype == "affine":
            n_params += params["kernel"].size + params["bias"].size
            extra = f" input-dim {din} output-dim {dout}"
        elif ctype == "splice":
            offs = np.asarray(params["offsets"]).reshape(-1)
            extra = " offsets " + " ".join(str(int(o)) for o in offs)
        elif ctype == "pnorm":
            extra = (f" output-dim {dout} p "
                     f"{float(np.asarray(params['p']).reshape(())):g}")
        print(f"component {i} : {ctype}{extra}")
    print(f"num-parameters {n_params}")
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py raw_nnet_concat_tool.
@tool("raw-nnet-concat")
def raw_nnet_concat_tool(argv):
    """Concatenate raw nets: net2 consumes net1's output
    (nnet2bin/raw-nnet-concat.cc); affine boundary dims checked."""
    from kaldi_tpu_torch.am.raw_nnet import load_raw_nnet, save_raw_nnet
    po = ParseOptions("raw-nnet-concat <raw-in1> <raw-in2> <raw-out>")
    args = po.read(argv)
    a = load_raw_nnet(args[0])
    b = load_raw_nnet(args[1])
    a_out = next((int(p["kernel"].shape[1]) for t, p in reversed(a)
                  if t == "affine"), None)
    b_in = next((int(p["kernel"].shape[0]) for t, p in b
                 if t == "affine"), None)
    b_splice = next((len(np.asarray(p["offsets"]).reshape(-1))
                     for t, p in b if t == "splice"), 1)
    if a_out is not None and b_in is not None \
            and a_out * b_splice != b_in:
        raise KaldiError(f"raw-nnet-concat: dim mismatch {a_out} "
                         f"(×{b_splice} splice) vs {b_in}")
    save_raw_nnet(args[2], a + b)
    log.info("raw-nnet-concat: %d + %d components", len(a), len(b))
    return 0


# ---------------------------------------------------------------------------
# forward / diagnostics
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank26.py nnet_am_compute_tool.
@tool("nnet-am-compute")
def nnet_am_compute_tool(argv):
    """Forward features through an nnet2 am: log-posteriors, or
    pseudo-loglikelihoods with --divide-by-priors
    (nnet2bin/nnet-am-compute.cc), on ``--device``."""
    po = ParseOptions("nnet-am-compute [opts] <nnet2-in> "
                      "<feats-rspec> <mat-wspec>")
    po.register("divide-by-priors", bool, False,
                "subtract log-priors (decode-side likelihoods)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    model, _cfg, logpri = load_nnet2_scorer(
        args[0], device, divide_by_priors=po["divide-by-priors"])
    if po["divide-by-priors"] and logpri is None:
        raise KaldiError("nnet-am-compute: model has no priors "
                         "(run nnet-adjust-priors)")
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            w[key] = nnet2_scores(model, feats, device, logpri
                                  ).cpu().numpy()
            n += 1
    log.info("nnet-am-compute: %d utterances", n)
    return 0


def compute_prob(model, egs_rspec: str, device) -> float:
    """Average per-frame log-probability of the egs' targets under
    ``model`` on ``device`` (float64 sums on the host)."""
    tot, n = 0.0, 0
    for _key, eg in SequentialTableReader(egs_rspec, holder="xeg"):
        x = torch.tensor(np.asarray(eg.feats, np.float32)).to(device)
        t = torch.tensor(np.asarray(eg.pdfs, np.int64)).to(device)
        with torch.no_grad():
            ll = torch.gather(model(x), -1, t[..., None])
        tot += float(ll.double().sum())
        n += int(ll.numel())
    if n == 0:
        raise KaldiError("nnet-compute-prob: no examples")
    return tot / n


# Port of kaldi_tpu/cli/tools_bank26.py nnet_compute_prob_tool.
@tool("nnet-compute-prob")
def nnet_compute_prob_tool(argv):
    """Average per-frame log-probability of egs under a model — the
    train/valid diagnostic (nnet2bin/nnet-compute-prob.cc), on
    ``--device``."""
    po = ParseOptions("nnet-compute-prob <nnet2-in> <egs-rspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    model, _cfg, _ = load_nnet2_scorer(args[0], device,
                                       divide_by_priors=False)
    avg = compute_prob(model, args[1], device)
    print(f"{avg:.6f}")
    log.info("nnet-compute-prob: avg log-prob %.4f", avg)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_show_progress_tool.
@tool("nnet-show-progress")
def nnet_show_progress_tool(argv):
    """Per-layer parameter change between two models, plus the objf
    delta on probe egs when given (nnet2bin/nnet-show-progress.cc);
    the probe's forwards on ``--device``."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2, tree_leaves
    po = ParseOptions("nnet-show-progress <nnet2-old> <nnet2-new> "
                      "[<egs-rspec>]")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    p_old, cfg_old = load_nnet2(args[0])
    p_new, cfg_new = load_nnet2(args[1])
    if cfg_old != cfg_new:
        log.warning("nnet-show-progress: configs differ; comparing "
                    "matching leaves only")
    flat_new = dict(tree_leaves(p_new))
    for path, v_old in tree_leaves(p_old):
        if path not in flat_new:
            continue
        v_old = np.asarray(v_old)
        v_new = np.asarray(flat_new[path])
        if v_old.shape != v_new.shape:
            continue
        d = np.linalg.norm(v_new - v_old)
        base = np.linalg.norm(v_old) + 1e-20
        print(f"{'/'.join(path)} rel-change {d / base:.6f}")
    if len(args) > 2:
        for tag, mdl in (("old", args[0]), ("new", args[1])):
            model, _cfg, _ = load_nnet2_scorer(mdl, device,
                                               divide_by_priors=False)
            print(f"objf-{tag} {compute_prob(model, args[2], device):.6f}")
    return 0


# ---------------------------------------------------------------------------
# priors and transitions
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank26.py nnet_train_transitions_tool.
@tool("nnet-train-transitions")
def nnet_train_transitions_tool(argv):
    """Re-estimate transition probs from alignments and set the
    model's pdf priors from the same counts
    (nnet2bin/nnet-train-transitions.cc; upstream edits the bundled
    am-nnet .mdl — here the TransitionModel file and the nnet2 file
    are the two halves of that bundle)."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    from kaldi_tpu_torch.am.serialize import (read_transition_model,
                                              write_transition_model)
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet-train-transitions <trans-model-in> "
                      "<ali-rspec> <nnet2-in> <trans-model-out> "
                      "<nnet2-out>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        tm = read_transition_model(f)
    params, cfg, _old = load_nnet2_full(args[2])
    tid_counts = np.zeros(tm.num_transition_ids + 1)
    pdf_counts = np.zeros(cfg.num_pdfs)
    n = 0
    for _key, ali in SequentialTableReader(args[1], holder="ivec"):
        tids = np.asarray(ali, np.int64)
        np.add.at(tid_counts, tids, 1.0)
        np.add.at(pdf_counts, tm.tid_to_pdf_array[tids], 1.0)
        n += 1
    if n == 0:
        raise KaldiError("nnet-train-transitions: no alignments")
    tm.mle_update(tid_counts)
    priors = (pdf_counts + 0.5) / (pdf_counts.sum()
                                   + 0.5 * len(pdf_counts))
    with kio.open_wxfilename(args[3]) as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, tm)
    save_nnet2(args[4], params, cfg, priors=priors)
    log.info("nnet-train-transitions: %d alignments, prior entropy "
             "%.3f", n, -float((priors * np.log(priors)).sum()))
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_adjust_priors_tool.
@tool("nnet-adjust-priors")
def nnet_adjust_priors_tool(argv):
    """Set the model's pdf priors from a counts/posterior-sum vector
    (nnet2bin/nnet-adjust-priors.cc)."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-adjust-priors <nnet2-in> "
                      "<counts-rxfilename> <nnet2-out>")
    args = po.read(argv)
    params, cfg, _old = load_nnet2_full(args[0])
    counts = _read_priors_vec(args[1])
    if len(counts) != cfg.num_pdfs:
        raise KaldiError(f"nnet-adjust-priors: {len(counts)} counts "
                         f"vs {cfg.num_pdfs} pdfs")
    priors = (counts + 0.5) / (counts.sum() + 0.5 * len(counts))
    save_nnet2(args[2], params, cfg, priors=priors)
    log.info("nnet-adjust-priors: priors set (entropy %.3f)",
             -float((priors * np.log(priors)).sum()))
    return 0


# ---------------------------------------------------------------------------
# model surgery
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank26.py nnet_insert_tool.
@tool("nnet-insert")
def nnet_insert_tool(argv):
    """Insert a fresh random hidden layer (nnet2bin/nnet-insert.cc —
    the discriminative-recipe net-growing step).  The new p-norm
    layer goes before the output affine; existing layers keep their
    parameters."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-insert [opts] <nnet2-in> <nnet2-out>")
    po.register("srand", int, 0, "init seed")
    po.register("stddev-factor", float, 0.1,
                "scale of the new layer's random init")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    new_cfg = dataclasses.replace(
        cfg, num_hidden_layers=cfg.num_hidden_layers + 1)
    rng = np.random.default_rng(po["srand"])
    in_dim = cfg.pnorm_output_dim
    k = rng.standard_normal((in_dim, cfg.pnorm_input_dim)) \
        * po["stddev-factor"] / np.sqrt(in_dim)
    new_layer = {"affine": {
        "kernel": k.astype(np.float32),
        "bias": np.zeros(cfg.pnorm_input_dim, np.float32)}}
    new_params = {f"pnorm{i + 1}": params[f"pnorm{i + 1}"]
                  for i in range(cfg.num_hidden_layers)}
    new_params[f"pnorm{new_cfg.num_hidden_layers}"] = new_layer
    new_params["output_affine"] = params["output_affine"]
    save_nnet2(args[1], new_params, new_cfg, priors=priors)
    log.info("nnet-insert: %d → %d hidden layers",
             cfg.num_hidden_layers, new_cfg.num_hidden_layers)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_replace_last_layers_tool.
@tool("nnet-replace-last-layers")
def nnet_replace_last_layers_tool(argv):
    """Replace the last hidden layers + output affine with fresh
    random ones, optionally retargeting a new pdf count
    (nnet2bin/nnet-replace-last-layers.cc — transfer learning)."""
    from kaldi_tpu_torch.am.nnet2 import (init_nnet2, load_nnet2_full,
                                          save_nnet2)
    po = ParseOptions("nnet-replace-last-layers [opts] <nnet2-in> "
                      "<nnet2-out>")
    po.register("num-layers-to-remove", int, 1,
                "hidden layers to re-init (from the top)")
    po.register("num-pdfs", int, 0, "new output dim (0 = keep)")
    po.register("srand", int, 0, "init seed")
    args = po.read(argv)
    params, cfg, _priors = load_nnet2_full(args[0])
    n_rm = po["num-layers-to-remove"]
    if n_rm < 0 or n_rm > cfg.num_hidden_layers:
        raise KaldiError("nnet-replace-last-layers: bad "
                         "--num-layers-to-remove")
    new_cfg = dataclasses.replace(
        cfg, num_pdfs=po["num-pdfs"] or cfg.num_pdfs, mix2pdf=None)
    fresh = init_nnet2(new_cfg, torch.Generator().manual_seed(po["srand"]))
    keep = cfg.num_hidden_layers - n_rm
    new_params = dict(fresh)
    for i in range(keep):
        new_params[f"pnorm{i + 1}"] = params[f"pnorm{i + 1}"]
    save_nnet2(args[1], new_params, new_cfg)
    log.info("nnet-replace-last-layers: kept %d layers, new output "
             "%d pdfs", keep, new_cfg.num_pdfs)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_am_widen_tool.
@tool("nnet-am-widen")
def nnet_am_widen_tool(argv):
    """Widen every hidden layer's p-norm input dim
    (nnet2bin/nnet-am-widen.cc): existing affine columns are kept,
    new columns get small random values; group size grows so the
    p-norm output dim is unchanged."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-am-widen --hidden-layer-dim=N <nnet2-in> "
                      "<nnet2-out>")
    po.register("hidden-layer-dim", int, 0,
                "new p-norm input dim (must be a multiple of the "
                "p-norm output dim)")
    po.register("srand", int, 0, "init seed")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    new_dim = po["hidden-layer-dim"]
    if new_dim <= cfg.pnorm_input_dim:
        raise KaldiError("nnet-am-widen: --hidden-layer-dim must "
                         "exceed the current p-norm input dim")
    if new_dim % cfg.pnorm_output_dim:
        raise KaldiError("nnet-am-widen: new dim must be a multiple "
                         "of the p-norm output dim")
    rng = np.random.default_rng(po["srand"])
    new_params = dict(params)
    for i in range(cfg.num_hidden_layers):
        layer = params[f"pnorm{i + 1}"]["affine"]
        k = np.asarray(layer["kernel"], np.float32)
        b = np.asarray(layer["bias"], np.float32)
        extra = new_dim - k.shape[1]
        k2 = np.concatenate([k, rng.standard_normal(
            (k.shape[0], extra)).astype(np.float32)
            * 0.02 / np.sqrt(k.shape[0])], axis=1)
        b2 = np.concatenate([b, np.zeros(extra, np.float32)])
        new_params[f"pnorm{i + 1}"] = {"affine": {"kernel": k2,
                                                  "bias": b2}}
    new_cfg = dataclasses.replace(cfg, pnorm_input_dim=new_dim)
    save_nnet2(args[1], new_params, new_cfg, priors=priors)
    log.info("nnet-am-widen: p-norm input %d → %d",
             cfg.pnorm_input_dim, new_dim)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_am_mixup_tool.
@tool("nnet-am-mixup")
def nnet_am_mixup_tool(argv):
    """Mix up the softmax layer (nnet2bin/nnet-am-mixup.cc /
    SoftmaxComponent::MixUp): pdfs gain extra mixture rows in the
    output affine — duplicated with a small perturbation — and the
    model sums their posteriors per pdf (grouped logsumexp; see
    Nnet2Config.mix2pdf).  Rows are allotted to pdfs by prior mass
    when the model has priors, else uniformly."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-am-mixup --num-mixtures=M <nnet2-in> "
                      "<nnet2-out>")
    po.register("num-mixtures", int, 0,
                "total mixture rows (must exceed num-pdfs)")
    po.register("srand", int, 0, "perturbation seed")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    if cfg.mix2pdf is not None:
        raise KaldiError("nnet-am-mixup: model already mixed up")
    M = po["num-mixtures"]
    P = cfg.num_pdfs
    if M <= P:
        raise KaldiError(f"nnet-am-mixup: --num-mixtures={M} must "
                         f"exceed num-pdfs={P}")
    mass = (np.asarray(priors, np.float64) if priors is not None
            else np.full(P, 1.0 / P))
    mass = mass / mass.sum()
    # largest-remainder allotment of the M - P extra rows
    extra = M - P
    want = mass * extra
    alloc = np.floor(want).astype(int)
    rem = extra - alloc.sum()
    if rem > 0:
        order = np.argsort(-(want - alloc), kind="stable")
        alloc[order[:rem]] += 1
    out = params["output_affine"]
    k = np.asarray(out["kernel"], np.float32)        # (H, P)
    b = np.asarray(out["bias"], np.float32)
    rng = np.random.default_rng(po["srand"])
    cols, bias, mix2pdf = [], [], []
    for p in range(P):
        n_rows = 1 + int(alloc[p])
        for _ in range(n_rows):
            cols.append(k[:, p] + rng.standard_normal(k.shape[0])
                        .astype(np.float32) * 0.01)
            # splitting one row into n gives each ~1/n of the mass
            bias.append(b[p] - np.log(n_rows).astype(np.float32))
            mix2pdf.append(p)
    new_params = dict(params)
    new_params["output_affine"] = {"kernel": np.stack(cols, axis=1),
                                   "bias": np.asarray(bias, np.float32)}
    new_cfg = dataclasses.replace(cfg, mix2pdf=tuple(mix2pdf))
    save_nnet2(args[1], new_params, new_cfg, priors=priors)
    log.info("nnet-am-mixup: %d pdfs → %d mixture rows", P, M)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_am_switch_preconditioning_tool.
@tool("nnet-am-switch-preconditioning")
def nnet_am_switch_preconditioning_tool(argv):
    """Toggle NG-SGD preconditioning for subsequent training
    (nnet2bin/nnet-am-switch-preconditioning.cc; trainers consult the
    flag)."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-am-switch-preconditioning "
                      "[--preconditioned=true] <nnet2-in> <nnet2-out>")
    po.register("preconditioned", bool, True, "target state")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    new_cfg = dataclasses.replace(cfg,
                                  preconditioned=po["preconditioned"])
    save_nnet2(args[1], params, new_cfg, priors=priors)
    log.info("nnet-am-switch-preconditioning: %s → %s",
             cfg.preconditioned, new_cfg.preconditioned)
    return 0


# ---------------------------------------------------------------------------
# alignment / decoding
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank26.py nnet_align_compiled_tool.
@tool("nnet-align-compiled")
def nnet_align_compiled_tool(argv):
    """Forced alignment with nnet2 pseudo-loglikelihoods over
    compiled training graphs (nnet2bin/nnet-align-compiled.cc): the
    network and ``DenseAligner`` on ``--device``."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_bank28 import align_compiled
    po = ParseOptions("nnet-align-compiled [opts] <trans-model> "
                      "<nnet2-in> <graphs-rspec> <feats-rspec> "
                      "<ali-wspec>")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    model, _cfg, logpri = load_nnet2_scorer(args[1], device)
    scored = ((key, nnet2_scores(model, m, device, logpri)) for key, m in
              SequentialTableReader(args[3], holder="mat"))
    align_compiled("nnet-align-compiled", tm.tid_to_pdf_array, args[2],
                   scored, args[4], po["acoustic-scale"], device)
    return 0


# Port of kaldi_tpu/cli/tools_bank26.py nnet_latgen_faster_parallel_tool.
@tool("nnet-latgen-faster-parallel")
def nnet_latgen_faster_parallel_tool(argv):
    """Threaded nnet2 lattice decoding — the TaskSequencer role
    (nnet2bin/nnet-latgen-faster-parallel.cc): ``--num-threads``
    utterances at once, each thread with a decoder of its own on
    ``--device`` and the one network there."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    po = ParseOptions("nnet-latgen-faster-parallel [opts] "
                      "<trans-model> <nnet2-in> <fst> <feats-rspec> "
                      "<lattice-wspec>")
    _latgen_po(po)
    po.register("num-threads", int, 4, "host worker threads")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, HCLG = latgen_inputs(args[0], args[2])
    model, _cfg, logpri = load_nnet2_scorer(args[1], device)
    local = threading.local()

    def one(item):
        key, feats = item
        if not hasattr(local, "dec"):
            local.dec = latgen_decoder(po, tm, HCLG, device)
        ll = nnet2_scores(model, feats, device, logpri)
        return key, local.dec.decode_to_clat(ll)

    entries = list(SequentialTableReader(args[3], holder="mat"))
    with ThreadPoolExecutor(max_workers=po["num-threads"]) as pool:
        results = list(pool.map(one, entries))
    with TableWriter(args[4], holder="clat") as w:
        for key, clat in results:
            w[key] = clat
    log.info("nnet-latgen-faster-parallel: %d utterances on %d "
             "threads", len(results), po["num-threads"])
    return 0
