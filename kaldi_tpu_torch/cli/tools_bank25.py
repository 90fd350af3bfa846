"""Port of kaldi_tpu/cli/tools_bank25.py's nnet1 ("Karel") tail (parity
targets nnetbin/{nnet-initialize, transf-to-nnet, nnet-train-perutt,
nnet-train-mmi-sequential, nnet-train-mpe-sequential}.cc) and its nnet2
tools (nnet2bin/{nnet-am-copy, nnet-compute, nnet-am-fix}.cc),
registered in cli/tools.py's ``TOOLS``.  nnet-initialize draws flax's
initializers' distributions (lecun_normal kernels, zero biases) from a
``torch.Generator`` seeded by ``--seed`` (the original's bits come from
``PRNGKey(seed)``); transf-to-nnet is host numpy; nnet-train-perutt and
the two sequence trainers run the sigmoid DNN (and the
am/discriminative.py objectives) on ``--device`` (default cuda).  The
nnet2 spellings nnet-am-copy and nnet-compute run the flows of bank
19's nnet2-am-copy and nnet2-compute (nnet-compute takes ``--device``);
nnet-am-fix is host numpy.  nnet-am-copy and nnet-am-fix carry the
model's ``<Priors>``, which the originals drop (ported to intent).

The sequence trainers keep two faults of the original (ROADMAP,
"Reference faults to port to intent"): MMI and sMBR score the lattice
with the network's log-posteriors (no priors subtracted), and the
numerator alignment is not united into the denominator lattice.  One is
ported to intent: the original hands ``lattice_to_dense`` the expanded
lattice as it is and fails on any decoder lattice, whose word-boundary
arcs carry no transition id (ε); the port removes such arcs first
(``remove_eps_arcs``, path sums kept), and leaves an ε-free lattice as
the original does.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank25.py nnet_am_copy_tool.
@tool("nnet-am-copy")
def nnet_am_copy_tool(argv):
    """Copy/convert an nnet2 model — the upstream nnet2bin spelling
    (nnet2bin/nnet-am-copy.cc); same flow as nnet2-am-copy."""
    from kaldi_tpu_torch.cli.tools_bank19 import nnet2_am_copy_tool
    return nnet2_am_copy_tool(argv)


# Port of kaldi_tpu/cli/tools_bank25.py nnet_compute_tool.
@tool("nnet-compute")
def nnet_compute_tool(argv):
    """Forward features through an nnet2 model — upstream spelling
    (nnet2bin/nnet-compute.cc); same flow as nnet2-compute."""
    from kaldi_tpu_torch.cli.tools_bank19 import nnet2_compute_tool
    return nnet2_compute_tool(argv)


# Port of kaldi_tpu/cli/tools_bank25.py nnet_am_fix_tool.
@tool("nnet-am-fix")
def nnet_am_fix_tool(argv):
    """Repair an nnet2 model's parameters
    (nnet2bin/nnet-am-fix.cc): replace non-finite values and clip
    magnitudes to --max-param-value; the priors are kept."""
    from kaldi_tpu_torch.am.nnet2 import load_nnet2_full, save_nnet2, \
        tree_map
    po = ParseOptions("nnet-am-fix [opts] <nnet2-in> <nnet2-out>")
    po.register("max-param-value", float, 20.0, "magnitude clip")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    cap = po["max-param-value"]
    n_fixed = [0]

    def fix(a):
        a = np.asarray(a)
        bad = ~np.isfinite(a)
        n_fixed[0] += int(bad.sum())
        a = np.where(bad, 0.0, a)
        over = np.abs(a) > cap
        n_fixed[0] += int(over.sum())
        return np.clip(a, -cap, cap)

    params = tree_map(fix, params)
    save_nnet2(args[1], params, cfg, priors=priors)
    log.info("nnet-am-fix: %d values repaired/clipped", n_fixed[0])
    return 0


# ---------------------------------------------------------------------------
# nnet1 tail
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank25.py nnet_initialize_tool.
@tool("nnet-initialize")
def nnet_initialize_tool(argv):
    """Random-init an nnet1 from a text prototype
    (nnetbin/nnet-initialize.cc; proto = the
    utils/nnet/make_nnet_proto.py output: <AffineTransform> layers
    with <InputDim>/<OutputDim>, nonlinearity lines between)."""
    from kaldi_tpu_torch.am.nnet1 import init_nnet1, save_nnet1
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet-initialize [--seed=777] <nnet-proto> "
                      "<nnet-out>")
    po.register("seed", int, 777, "init seed")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        text = f.read().decode()
    dims: List[tuple] = []
    for m in re.finditer(r"<AffineTransform>\s*<InputDim>\s*(\d+)"
                         r"\s*<OutputDim>\s*(\d+)", text):
        dims.append((int(m.group(1)), int(m.group(2))))
    if not dims:
        raise KaldiError("nnet-initialize: no <AffineTransform> "
                         "layers in proto")
    for (_, o1), (i2, _) in zip(dims, dims[1:]):
        if o1 != i2:
            raise KaldiError(f"nnet-initialize: dim mismatch {o1} vs "
                             f"{i2}")
    feat_dim = dims[0][0]
    hid_dims = tuple(o for _, o in dims[:-1])
    num_pdfs = dims[-1][1]
    params = init_nnet1(feat_dim, hid_dims, num_pdfs,
                        torch.Generator().manual_seed(po["seed"]))
    save_nnet1(args[1], params, hid_dims, num_pdfs)
    log.info("nnet-initialize: %d → %s → %d", feat_dim,
             list(hid_dims), num_pdfs)
    return 0


# Copied from kaldi_tpu/cli/tools_bank25.py transf_to_nnet_tool.
@tool("transf-to-nnet")
def transf_to_nnet_tool(argv):
    """Wrap an affine/linear feature transform as a one-component
    feature-transform nnet (nnetbin/transf-to-nnet.cc); consumed by
    nnet-forward --feature-transform."""
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("transf-to-nnet <transform-rxfilename> "
                      "<nnet-out>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        mat = np.asarray(kio.read_matrix(f), np.float64)
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<Nnet1Transform>")
        kio.write_matrix(f, mat)
        kio.write_token(f, "</Nnet1Transform>")
    log.info("transf-to-nnet: %s transform", mat.shape)
    return 0


# Copied from kaldi_tpu/cli/tools_bank25.py read_nnet1_transform.
def read_nnet1_transform(path: str) -> np.ndarray:
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<Nnet1Transform>")
        mat = np.asarray(kio.read_matrix(f))
        kio.expect_token(f, "</Nnet1Transform>")
    return mat


# Port of kaldi_tpu/cli/tools_bank25.py nnet_train_perutt_tool.
@tool("nnet-train-perutt")
def nnet_train_perutt_tool(argv):
    """Per-utterance (unshuffled) xent SGD on an nnet1 on ``--device``
    (nnetbin/nnet-train-perutt.cc — recurrent-friendly ordering;
    contrast nnet-train-frmshuff)."""
    from kaldi_tpu_torch.am.nnet1 import (load_nnet1, nnet1_model,
                                          save_nnet1, sgd_step)
    po = ParseOptions("nnet-train-perutt [opts] <nnet-in> "
                      "<feats-rspec> <pdf-ali-rspec> <nnet-out>")
    po.register("learn-rate", float, 8e-3, "SGD learning rate")
    po.register("num-epochs", int, 1, "sweeps over the data")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    params, hid_dims, num_pdfs, priors = load_nnet1(args[0])
    model = nnet1_model(params, hid_dims, num_pdfs, device).train()
    ali_r = RandomAccessTableReader(args[2], holder="ivec")
    data = []
    for k, f in SequentialTableReader(args[1], holder="mat"):
        if k in ali_r:
            x = np.asarray(f, np.float32)
            y = np.asarray(ali_r[k], np.int64)
            T = min(len(x), len(y))
            data.append((torch.tensor(x[:T], device=device),
                         torch.tensor(y[:T], device=device)))
    if not data:
        raise KaldiError("nnet-train-perutt: no aligned utterances")
    loss = None
    for _ in range(po["num-epochs"]):
        for x, y in data:
            loss = -torch.gather(model(x), 1, y[:, None]).mean()
            sgd_step(model, loss, po["learn-rate"])
            loss = loss.detach()
    save_nnet1(args[3], model, hid_dims, num_pdfs, priors)
    log.info("nnet-train-perutt: %d utts × %d epochs, last xent %.4f",
             len(data), po["num-epochs"], float(loss))
    return 0


# Port of kaldi_tpu/cli/tools_bank25.py _nnet1_sequential.
def _nnet1_sequential(argv, name: str, criterion: str):
    """Shared MMI/MPE sequence-training flow
    (nnetbin/nnet-train-{mmi,mpe}-sequential.cc): per utterance,
    backprop the sequence objective through the DNN on ``--device``;
    denominator = the utterance's decode lattice (ε arcs removed),
    numerator = the alignment."""
    from kaldi_tpu_torch.am.discriminative import (lattice_to,
                                                   lattice_to_dense,
                                                   mmi_objf,
                                                   remove_eps_arcs,
                                                   smbr_objf)
    from kaldi_tpu_torch.am.nnet1 import (load_nnet1, nnet1_model,
                                          save_nnet1, sgd_step)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.lattice import compact_to_lattice
    po = ParseOptions(f"{name} [opts] <trans-model> <nnet-in> "
                      "<feats-rspec> <ali-rspec> <lat-rspec> "
                      "<nnet-out>")
    po.register("learn-rate", float, 1e-4, "SGD learning rate")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    params, hid_dims, num_pdfs, priors = load_nnet1(args[1])
    model = nnet1_model(params, hid_dims, num_pdfs, device).train()
    ali_r = RandomAccessTableReader(args[3], holder="ivec")
    lat_r = RandomAccessTableReader(args[4], holder="clat")
    scale = po["acoustic-scale"]
    n = 0
    tot = 0.0
    for key, feats in SequentialTableReader(args[2], holder="mat"):
        if key not in ali_r or key not in lat_r:
            continue
        x = np.asarray(feats, np.float32)
        tids = np.asarray(ali_r[key], np.int64)
        num_pdf = tm.tid_to_pdf_array[tids]
        raw = compact_to_lattice(lat_r[key])
        if any(a.ilabel == 0 for arcs in raw.arcs for a in arcs):
            raw = remove_eps_arcs(raw)
        dense = lattice_to_dense(raw, tm.tid_to_pdf_array)
        T = min(len(x), len(num_pdf), dense.T)
        if T < dense.T:
            log.warning("%s: %s lattice spans %d frames > %d "
                        "available; skipped", name, key, dense.T, T)
            continue
        lat = lattice_to(dense, device)
        scores = model(torch.tensor(x[:T], device=device))
        if criterion == "mmi":
            objf = mmi_objf(lat, scores, num_pdf[:T], acoustic_scale=scale)
        else:
            acc = (np.asarray(dense.pdf) == num_pdf[:dense.T, None]
                   ).astype(np.float32)
            objf = smbr_objf(lat, scores, acc, acoustic_scale=scale)
        sgd_step(model, -objf, po["learn-rate"])
        tot += float(objf.detach())
        n += 1
    if n == 0:
        raise KaldiError(f"{name}: no trainable utterances")
    save_nnet1(args[5], model, hid_dims, num_pdfs, priors)
    log.info("%s: %d utterances, mean objf %.4f", name, n, tot / n)
    return 0


# Port of kaldi_tpu/cli/tools_bank25.py nnet_train_mmi_sequential_tool.
@tool("nnet-train-mmi-sequential")
def nnet_train_mmi_sequential_tool(argv):
    """MMI sequence training of an nnet1
    (nnetbin/nnet-train-mmi-sequential.cc)."""
    return _nnet1_sequential(argv, "nnet-train-mmi-sequential", "mmi")


# Port of kaldi_tpu/cli/tools_bank25.py nnet_train_mpe_sequential_tool.
@tool("nnet-train-mpe-sequential")
def nnet_train_mpe_sequential_tool(argv):
    """MPE/sMBR sequence training of an nnet1
    (nnetbin/nnet-train-mpe-sequential.cc; state-level accuracy =
    sMBR, the --do-smbr=true flavor)."""
    return _nnet1_sequential(argv, "nnet-train-mpe-sequential", "mpe")
