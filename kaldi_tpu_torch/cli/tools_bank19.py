"""Port of kaldi_tpu/cli/tools_bank19.py: the nnet1 ("Karel") tools
(parity targets nnetbin/{nnet-info, nnet-copy, nnet-concat, nnet-forward,
rbm-train-cd1-frmshuff, rbm-convert-to-nnet, nnet-train-frmshuff,
cmvn-to-nnet}.cc) and the nnet2 tools (nnet2bin/{nnet-am-info,
nnet-am-init, nnet-am-copy, nnet-am-average, nnet-compute,
nnet-train-simple, nnet-latgen-faster}.cc), registered in cli/tools.py's
``TOOLS``: nnet-am-info, nnet-am-init, nnet2-am-copy, nnet-am-average,
nnet-train-simple, nnet2-compute and nnet-latgen-faster.  Where an
upstream name collides with an nnet3 tool the nnet2 variant keeps the
original's 'nnet2-' prefix.  The model tools are host numpy on flax's
parameter tree (am/nnet1.py, am/nnet2.py); nnet-forward,
rbm-train-cd1-frmshuff, nnet-train-frmshuff, nnet-train-simple,
nnet2-compute and nnet-latgen-faster run the network (and the decoder)
on ``--device`` (default cuda).  The nnet1 tools are the original's, as
they are (its draws: ``np.random.default_rng``, and CD-1's uniforms from
``am/nnet1.py`` ``draw_uniform``).

Ported to intent, not as they are:
* nnet-latgen-faster decodes pseudo-log-likelihoods: the model's
  log-priors are subtracted when its file has them (the original reads
  through ``load_nnet2``, which drops ``<Priors>``, and decodes raw
  log-posteriors; Kaldi's nnet2 decodables divide by the priors, as
  the original's online2 and alignment tools do).
* nnet2-am-copy and nnet-am-average carry the model's ``<Priors>`` (the
  average keeps its first input's); the originals drop them.
* nnet-am-init draws flax's initializers' distributions from a
  ``torch.Generator`` seeded by ``--srand`` (the original's bits come
  from ``PRNGKey(srand)``).
* rbm-train-cd1-frmshuff takes the upstream ``--learn-rate`` (default
  the original's fixed 0.05): at 0.05 a Gaussian-Bernoulli RBM of 256
  or more hidden units on normalized inputs diverges, in the original
  as here (its reconstruction grows with the number of hidden units).
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


def load_nnet2_scorer(path: str, device, divide_by_priors: bool = True):
    """An nnet2 file → (``Nnet2Model`` in eval mode on ``device``, its
    config, the log-priors as a tensor there, or None when the file has
    none or ``divide_by_priors`` is off)."""
    from kaldi_tpu_torch.am.nnet2 import (load_nnet2_full, log_priors,
                                          nnet2_model)
    params, cfg, priors = load_nnet2_full(path)
    model = nnet2_model(params, cfg, device)
    logpri = None
    if divide_by_priors and priors is not None:
        logpri = torch.from_numpy(log_priors(priors)).to(device)
    return model, cfg, logpri


def nnet2_scores(model, feats, device, logpri=None) -> torch.Tensor:
    """One utterance's (T, D) features → (T, P) log-posteriors of
    ``model`` on ``device``, minus ``logpri`` when given
    (pseudo-log-likelihoods)."""
    x = torch.tensor(np.asarray(feats, np.float32)).to(device)
    with torch.no_grad():
        out = model(x[None])[0]
    return out if logpri is None else out - logpri


def _latgen_po(po: ParseOptions) -> None:
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")


def latgen_inputs(mdl: str, fst: str):
    """An nnet2 latgen tool's transition model and graph, on the
    host."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    tm, _ = read_mdl(mdl, device="cpu")
    return tm, _load_hclg(fst)


def latgen_decoder(po, tm, HCLG, device):
    """``_LatgenDecoder`` on ``device`` from an nnet2 latgen tool's
    options."""
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder
    return _LatgenDecoder(HCLG, tm.tid_to_pdf_array, po["beam"],
                          po["lattice-beam"], po["acoustic-scale"],
                          max_active=po["max-active"], device=device)


# Port of kaldi_tpu/cli/tools_bank19.py nnet_am_info_tool.
@tool("nnet-am-info")
def nnet_am_info_tool(argv):
    """Print nnet2 model structure (nnet2bin/nnet-am-info.cc)."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2
    po = ParseOptions("nnet-am-info <nnet2-in>")
    args = po.read(argv)
    _params, cfg = load_nnet2(args[0])
    print(f"feat-dim {cfg.feat_dim}")
    print(f"num-pdfs {cfg.num_pdfs}")
    print(f"num-hidden-layers {cfg.num_hidden_layers}")
    print(f"pnorm-input-dim {cfg.pnorm_input_dim}")
    print(f"pnorm-output-dim {cfg.pnorm_output_dim}")
    print(f"splice {' '.join(str(s) for s in cfg.splice)}")
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_am_init_tool.
@tool("nnet-am-init")
def nnet_am_init_tool(argv):
    """Random-initialize an nnet2 p-norm model
    (nnet2bin/nnet-am-init.cc role; topology from flags)."""
    from kaldi_tpu_torch.am.nnet2 import Nnet2Config, init_nnet2, save_nnet2
    po = ParseOptions("nnet-am-init [opts] <nnet2-out>")
    po.register("feat-dim", int, 0, "input dim (required)")
    po.register("num-pdfs", int, 0, "output dim (required)")
    po.register("num-hidden-layers", int, 3, "p-norm layers")
    po.register("pnorm-input-dim", int, 160, "p-norm group input dim")
    po.register("pnorm-output-dim", int, 32, "p-norm output dim")
    po.register("srand", int, 0, "seed")
    args = po.read(argv)
    if po["feat-dim"] <= 0 or po["num-pdfs"] <= 0:
        raise KaldiError("nnet-am-init: --feat-dim/--num-pdfs required")
    cfg = Nnet2Config(feat_dim=po["feat-dim"],
                      num_pdfs=po["num-pdfs"],
                      num_hidden_layers=po["num-hidden-layers"],
                      pnorm_input_dim=po["pnorm-input-dim"],
                      pnorm_output_dim=po["pnorm-output-dim"])
    params = init_nnet2(cfg, torch.Generator().manual_seed(po["srand"]))
    save_nnet2(args[0], params, cfg)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet2_am_copy_tool.
@tool("nnet2-am-copy")
def nnet2_am_copy_tool(argv):
    """Copy an nnet2 model (nnet2bin/nnet-am-copy.cc; 'nnet2-' prefix
    because nnet3's nnet3-am-copy owns the unprefixed role here), its
    priors with it."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet2-am-copy <nnet2-in> <nnet2-out>")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    save_nnet2(args[1], params, cfg, priors=priors)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_am_average_tool.
@tool("nnet-am-average")
def nnet_am_average_tool(argv):
    """Average nnet2 models — the parallel-SGD reduce step
    (nnet2bin/nnet-am-average.cc); the first input's priors are kept."""
    from kaldi_tpu_torch.am.nnet2 import tree_map, load_nnet2_full, \
        save_nnet2
    po = ParseOptions("nnet-am-average <nnet2-out> <nnet2-in1> "
                      "[<nnet2-in2> ...]")
    args = po.read(argv)
    models = [load_nnet2_full(p) for p in args[1:]]
    cfg, priors = models[0][1], models[0][2]
    avg = tree_map(
        lambda *xs: np.mean(np.stack([np.asarray(x) for x in xs]),
                            axis=0),
        *[p for p, _c, _pr in models])
    save_nnet2(args[0], avg, cfg, priors=priors)
    log.info("nnet-am-average: %d models", len(models))
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_train_simple_tool.
@tool("nnet-train-simple")
def nnet_train_simple_tool(argv):
    """One SGD pass over feats+ali on ``--device``
    (nnet2bin/nnet-train-simple.cc — the per-job worker the averaging
    loop fans out): a step each ``--chunk-size`` frames of an utterance,
    each layer's update scaled by the model's learning rates
    (am/nnet2.py ``train_simple``).  The output has no priors, as the
    original's."""
    from kaldi_tpu_torch.am.nnet2 import (load_nnet2, save_nnet2, train_simple,
                                          xent_chunks)
    po = ParseOptions("nnet-train-simple [opts] <nnet2-in> "
                      "<feats-rspec> <pdf-ali-rspec> <nnet2-out>")
    po.register("learning-rate", float, 2e-3, "SGD lr")
    po.register("chunk-size", int, 32, "frames per training chunk")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    params, cfg = load_nnet2(args[0])
    chunks = xent_chunks(SequentialTableReader(args[1], holder="mat"),
                         RandomAccessTableReader(args[2], holder="ivec"),
                         po["chunk-size"], device)
    params, loss, n_chunks = train_simple(params, cfg, chunks,
                                          po["learning-rate"], device)
    if loss is None:
        raise KaldiError("nnet-train-simple: no training chunks")
    save_nnet2(args[3], params, cfg)
    log.info("nnet-train-simple: %d chunks, final xent %.4f",
             n_chunks, loss)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet2_compute_tool.
@tool("nnet2-compute")
def nnet2_compute_tool(argv):
    """Forward feats through an nnet2 model → log-posteriors
    (nnet2bin/nnet-compute.cc; prefixed, see module docstring), on
    ``--device``."""
    po = ParseOptions("nnet2-compute <nnet2-in> <feats-rspec> "
                      "<mat-wspec>")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    model, _cfg, _ = load_nnet2_scorer(args[0], device,
                                       divide_by_priors=False)
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            w[key] = nnet2_scores(model, feats, device).cpu().numpy()
            n += 1
    log.info("nnet2-compute: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_latgen_faster_tool.
@tool("nnet-latgen-faster")
def nnet_latgen_faster_tool(argv):
    """Lattice decoding with nnet2 pseudo-loglikes
    (nnet2bin/nnet-latgen-faster.cc): the network and the decoder on
    ``--device``, the model's log-priors subtracted when it has them."""
    po = ParseOptions("nnet-latgen-faster [opts] <trans-model> "
                      "<nnet2-in> <fst> <feats-rspec> <lattice-wspec>")
    _latgen_po(po)
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    dec = latgen_decoder(po, *latgen_inputs(args[0], args[2]), device)
    model, _cfg, logpri = load_nnet2_scorer(args[1], device)
    n = 0
    with TableWriter(args[4], holder="clat") as lw:
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            lw[key] = dec.decode_to_clat(nnet2_scores(model, feats, device,
                                                      logpri))
            n += 1
    log.info("nnet-latgen-faster: decoded %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# nnet1 (nnetbin/) — sigmoid DNN + RBM pretraining.

def nnet1_log_priors(priors) -> np.ndarray:
    """An nnet1 file's class counts → the float32 log-priors
    nnet-forward --divide-by-priors subtracts, in the original's float32
    arithmetic (normalized, floored at 1e-20)."""
    priors = np.asarray(priors, np.float32)
    return np.log(np.maximum(priors / priors.sum(), 1e-20)).astype(
        np.float32)


def nnet1_frames(feats_rspec: str, ali_rspec: str):
    """The frames and pdf targets of every utterance of ``feats_rspec``
    that ``ali_rspec`` aligns, each cut to the shorter of the two,
    concatenated in table order (nnet-train-frmshuff's input)."""
    ali_r = RandomAccessTableReader(ali_rspec, holder="ivec")
    frames, targets = [], []
    for key, m in SequentialTableReader(feats_rspec, holder="mat"):
        if key not in ali_r:
            continue
        m = np.asarray(m, np.float32)
        a = np.asarray(ali_r[key], np.int32)
        frames.append(m[:len(a)])
        targets.append(a[:len(m)])
    if not frames:
        return None, None
    return np.concatenate(frames), np.concatenate(targets)


# Port of kaldi_tpu/cli/tools_bank19.py nnet_info_tool.
@tool("nnet-info")
def nnet_info_tool(argv):
    """Print nnet1 layer structure (nnetbin/nnet-info.cc)."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1
    po = ParseOptions("nnet-info <nnet1-in>")
    args = po.read(argv)
    params, hid_dims, num_pdfs, priors = load_nnet1(args[0])
    in_dim = params["hidden1"]["kernel"].shape[0] if hid_dims else 0
    print(f"input-dim {in_dim}")
    for i, hd in enumerate(hid_dims):
        print(f"component {i + 1} : <AffineTransform> + <Sigmoid> "
              f"dim {hd}")
    print(f"output-dim {num_pdfs}")
    print(f"has-priors {priors is not None}")
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_copy_tool.
@tool("nnet-copy")
def nnet_copy_tool(argv):
    """Copy an nnet1 model (nnetbin/nnet-copy.cc)."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1, save_nnet1
    po = ParseOptions("nnet-copy <nnet1-in> <nnet1-out>")
    args = po.read(argv)
    params, hid_dims, num_pdfs, priors = load_nnet1(args[0])
    save_nnet1(args[1], params, hid_dims, num_pdfs, priors)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_concat_tool.
@tool("nnet-concat")
def nnet_concat_tool(argv):
    """Concatenate nnet1 stacks: the second net consumes the first's
    output (nnetbin/nnet-concat.cc).  The first net's output layer is
    dropped (it becomes a hidden layer boundary) only when
    --drop-output=true; default stacks hidden layers of net1 with ALL
    layers of net2."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1, save_nnet1
    po = ParseOptions("nnet-concat [--drop-output=false] <nnet1-a> "
                      "<nnet1-b> <nnet1-out>")
    po.register("drop-output", bool, False,
                "drop net-a's output affine before stacking")
    args = po.read(argv)
    pa, ha, na, _pr = load_nnet1(args[0])
    pb, hb, nb, prb = load_nnet1(args[1])
    params = {}
    hid = []
    for i, hd in enumerate(ha):
        params[f"hidden{len(hid) + 1}"] = dict(pa[f"hidden{i + 1}"])
        hid.append(hd)
    if not po["drop-output"]:
        params[f"hidden{len(hid) + 1}"] = dict(pa["output_affine"])
        hid.append(na)
    for i, hd in enumerate(hb):
        params[f"hidden{len(hid) + 1}"] = dict(pb[f"hidden{i + 1}"])
        hid.append(hd)
    params["output_affine"] = dict(pb["output_affine"])
    save_nnet1(args[2], params, hid, nb, prb)
    log.info("nnet-concat: %d + %d layers → %d", len(ha), len(hb),
             len(hid))
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_forward_tool.
@tool("nnet-forward")
def nnet_forward_tool(argv):
    """Forward features through an nnet1 model on ``--device``
    (nnetbin/nnet-forward.cc): log-posteriors, optionally minus
    log-priors (--no-softmax/--apply-log analogue: output is always
    log-domain here; priors stored in the model file are divided out
    with --divide-by-priors)."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1, nnet1_model
    from kaldi_tpu_torch.am.transforms import apply_transform
    po = ParseOptions("nnet-forward [opts] <nnet1-in> <feats-rspec> "
                      "<mat-wspec>")
    po.register("divide-by-priors", bool, False,
                "subtract log-priors (pseudo-loglikelihoods)")
    po.register("feature-transform", str, "",
                "transf-to-nnet feature-transform applied before the "
                "DNN (the upstream --feature-transform)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    params, hid_dims, num_pdfs, priors = load_nnet1(args[0])
    model = nnet1_model(params, hid_dims, num_pdfs, device)
    ft = None
    if po["feature-transform"]:
        from kaldi_tpu_torch.cli.tools_bank25 import read_nnet1_transform
        ft = torch.tensor(np.asarray(read_nnet1_transform(
            po["feature-transform"]), np.float32), device=device)
    logp_prior = None
    if po["divide-by-priors"]:
        if priors is None:
            raise KaldiError("nnet-forward: model has no priors")
        logp_prior = torch.from_numpy(nnet1_log_priors(priors)).to(device)
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            x = torch.tensor(np.asarray(feats, np.float32), device=device)
            with torch.no_grad():
                if ft is not None:
                    x = apply_transform(x, ft)
                logp = model(x)
                if logp_prior is not None:
                    logp = logp - logp_prior
            w[key] = logp.cpu().numpy()
            n += 1
    log.info("nnet-forward: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py rbm_train_cd1_tool.
@tool("rbm-train-cd1-frmshuff")
def rbm_train_cd1_tool(argv):
    """Train one RBM layer with CD-1 on shuffled frames on ``--device``
    (nnetbin/rbm-train-cd1-frmshuff.cc); writes the RBM as a 1-layer
    nnet1 whose hidden layer is the RBM's up-pass."""
    from kaldi_tpu_torch.am.nnet1 import save_nnet1, train_rbm
    po = ParseOptions("rbm-train-cd1-frmshuff [opts] <feats-rspec> "
                      "<rbm-out>")
    po.register("hid-dim", int, 128, "hidden units")
    po.register("num-epochs", int, 4, "CD-1 epochs")
    po.register("gaussian-visible", bool, True,
                "Gaussian-Bernoulli first layer")
    po.register("learn-rate", float, 0.05,
                "CD-1 learning rate (the upstream option; the original "
                "fixes train_rbm's 0.05)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    frames = np.concatenate(
        [np.asarray(m, np.float32) for _k, m in
         SequentialTableReader(args[0], holder="mat")])
    rbm, recon_errs = train_rbm(frames, po["hid-dim"],
                                num_epochs=po["num-epochs"],
                                lr=po["learn-rate"],
                                gaussian_visible=po["gaussian-visible"],
                                device=device)
    params = {"hidden1": {"kernel": np.asarray(rbm.W),
                          "bias": np.asarray(rbm.hid_bias)},
              "output_affine": {
                  "kernel": np.zeros((po["hid-dim"], 1), np.float32),
                  "bias": np.zeros(1, np.float32)}}
    save_nnet1(args[1], params, [po["hid-dim"]], 1)
    log.info("rbm-train-cd1-frmshuff: recon err %.4f over %d frames",
             recon_errs[-1], len(frames))
    return 0


# Copied from kaldi_tpu/cli/tools_bank19.py rbm_convert_to_nnet_tool.
@tool("rbm-convert-to-nnet")
def rbm_convert_to_nnet_tool(argv):
    """RBM file → nnet1 layer (nnetbin/rbm-convert-to-nnet.cc; the RBM
    files already carry the up-pass as hidden1, so this validates +
    re-frames)."""
    from kaldi_tpu_torch.am.nnet1 import load_nnet1, save_nnet1
    po = ParseOptions("rbm-convert-to-nnet <rbm-in> <nnet1-out>")
    args = po.read(argv)
    params, hid_dims, _np_, _pr = load_nnet1(args[0])
    save_nnet1(args[1], {"hidden1": params["hidden1"],
                         "output_affine": params["output_affine"]},
               hid_dims[:1], 1)
    return 0


# Port of kaldi_tpu/cli/tools_bank19.py nnet_train_frmshuff_tool.
@tool("nnet-train-frmshuff")
def nnet_train_frmshuff_tool(argv):
    """Frame-shuffled cross-entropy SGD fine-tuning on ``--device``
    (nnetbin/nnet-train-frmshuff.cc); honors per-layer learning-rate
    factors set by nnet-set-learnrate."""
    from kaldi_tpu_torch.am.nnet1 import (finetune_xent, layer_names,
                                          load_nnet1_full, save_nnet1)
    po = ParseOptions("nnet-train-frmshuff [opts] <nnet1-in> "
                      "<feats-rspec> <pdf-ali-rspec> <nnet1-out>")
    po.register("num-epochs", int, 4, "epochs")
    po.register("learning-rate", float, 0.5, "SGD lr")
    po.register("minibatch-size", int, 256, "frames per minibatch")
    po.register("num-pdfs", int, 0,
                "resize (re-init) the output layer to this many "
                "targets (the nnet-initialize role when fine-tuning a "
                "pretrained stack whose output layer is a dummy)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    params, hid_dims, num_pdfs, priors, lr_vec = \
        load_nnet1_full(args[0])
    lr_factors = None
    if lr_vec is not None:
        lr_factors = {nm: float(v) for nm, v in
                      zip(layer_names(hid_dims), lr_vec)}
    if po["num-pdfs"] and po["num-pdfs"] != num_pdfs:
        rng0 = np.random.default_rng(0)
        out_in = int(hid_dims[-1])
        params = dict(params)
        params["output_affine"] = {
            "kernel": (0.01 * rng0.standard_normal(
                (out_in, po["num-pdfs"]))).astype(np.float32),
            "bias": np.zeros(po["num-pdfs"], np.float32)}
        num_pdfs = po["num-pdfs"]
    frames, targets = nnet1_frames(args[1], args[2])
    if frames is None:
        raise KaldiError("nnet-train-frmshuff: no matched utterances")
    params, loss = finetune_xent(
        params, list(hid_dims), num_pdfs, frames, targets,
        num_epochs=po["num-epochs"], batch_size=po["minibatch-size"],
        lr=po["learning-rate"], lr_factors=lr_factors, device=device)
    # class priors from the training targets (the ali-to-post →
    # nnet-forward --class-frame-counts flow, folded in)
    counts = np.bincount(targets, minlength=num_pdfs).astype(
        np.float64) + 0.5
    save_nnet1(args[3], params, hid_dims, num_pdfs,
               priors=counts.astype(np.float32))
    log.info("nnet-train-frmshuff: final xent %.4f over %d frames",
             loss, len(frames))
    return 0


# Copied from kaldi_tpu/cli/tools_bank19.py cmvn_to_nnet_tool.
@tool("cmvn-to-nnet")
def cmvn_to_nnet_tool(argv):
    """Global CMVN stats → a normalization transform (D, D+1) affine
    [diag(1/σ) | −μ/σ] (nnetbin/cmvn-to-nnet.cc writes
    AddShift+Rescale; here one affine consumable by
    transform-feats)."""
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("cmvn-to-nnet <cmvn-stats-in> "
                      "<transform-out>\nstats: the compute-cmvn-stats "
                      "2×(D+1) matrix")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        stats = np.asarray(kio.read_matrix(f), np.float64)
    cnt = stats[0, -1]
    mean = stats[0, :-1] / cnt
    var = np.maximum(stats[1, :-1] / cnt - mean ** 2, 1e-10)
    inv_std = 1.0 / np.sqrt(var)
    D = len(mean)
    mat = np.concatenate([np.diag(inv_std),
                          (-mean * inv_std)[:, None]], axis=1)
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, mat.astype(np.float32))
    log.info("cmvn-to-nnet: dim %d normalization transform", D)
    return 0
