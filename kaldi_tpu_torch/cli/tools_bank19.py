"""Port of the nnet2 tools of kaldi_tpu/cli/tools_bank19.py (parity
targets nnet2bin/{nnet-am-info, nnet-am-init, nnet-am-copy,
nnet-am-average, nnet-compute, nnet-latgen-faster}.cc), registered in
cli/tools.py's ``TOOLS``: nnet-am-info, nnet-am-init, nnet2-am-copy,
nnet-am-average, nnet2-compute and nnet-latgen-faster.  Where an
upstream name collides with an nnet3 tool the nnet2 variant keeps the
original's 'nnet2-' prefix.  The model tools are host numpy on flax's
parameter tree (am/nnet2.py); nnet2-compute and nnet-latgen-faster run
the network and the decoder on ``--device`` (default cuda).

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
