"""Port of kaldi_tpu/cli/tools_bank16.py's nnet3 discriminative egs
pipeline and sequence training (nnet3-discriminative-get-egs, -copy-egs,
-shuffle-egs, -train, -compute-objf; parity targets nnet3bin/
nnet3-discriminative-*.cc), decode-faster-mapped
(bin/decode-faster-mapped.cc) and the chain loop's nnet3-chain-subset-egs,
nnet3-chain-make-den-fst and nnet3-show-progress (host code, copied;
show-progress walks the flax tree ``params_to_flax`` gives, in the
original's leaf order), registered in cli/tools.py's ``TOOLS``.

The egs tools are the original's host numpy, copied, and write the
original's archives (holder ``deg``, pipelines/egs_io.py ``DiscEg``).
nnet3-discriminative-train and -compute-objf take ``--device`` (default
cuda): the raw TDNN-F, its forward and backward, the sequence objective's
frame loop (am/discriminative.py) and Adam run there, one eg a step, as
the library's ``sequence_step`` (pipelines/discriminative.py).
decode-faster-mapped runs the dense decoder there.
"""

from __future__ import annotations

import numpy as np
import torch

from kaldi_tpu_torch.cli.latgen import _load_hclg
from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_discriminative_get_egs_tool.
@tool("nnet3-discriminative-get-egs")
def nnet3_discriminative_get_egs_tool(argv):
    """Compile discriminative examples: feats + numerator pdf
    alignment + the utterance's denominator lattice, pre-flattened to
    the dense time-synchronous arrays the sequence objectives train on
    (nnet3bin/nnet3-discriminative-get-egs.cc)."""
    from kaldi_tpu_torch.am.discriminative import (lattice_to_dense,
                                                   remove_eps_arcs)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.lattice import compact_to_lattice
    from kaldi_tpu_torch.pipelines.egs_io import DiscEg
    po = ParseOptions("nnet3-discriminative-get-egs <model> "
                      "<feats-rspec> <pdf-ali-rspec> <denlats-rspec> "
                      "<degs-wspec>")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    ali_r = RandomAccessTableReader(args[2], holder="ivec")
    lat_r = RandomAccessTableReader(args[3], holder="clat")
    n = 0
    with TableWriter(args[4], holder="deg") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            if key not in ali_r or key not in lat_r:
                log.warning("nnet3-discriminative-get-egs: missing "
                            "ali/lattice for %s", key)
                continue
            feats = np.asarray(feats, np.float32)
            ali = np.asarray(ali_r[key], np.int32)
            raw = remove_eps_arcs(compact_to_lattice(lat_r[key]))
            dl = lattice_to_dense(raw, tm.tid_to_pdf_array)
            if dl.T > len(feats) or dl.T > len(ali):
                log.warning("%s: lattice frames %d exceed feats/ali",
                            key, dl.T)
                continue
            w[key] = DiscEg(feats=feats[:dl.T], num_ali=ali[:dl.T],
                            src=dl.src, dst=dl.dst, pdf=dl.pdf,
                            w=dl.w, mask=dl.mask, final=dl.final)
            n += 1
    log.info("nnet3-discriminative-get-egs: wrote %d examples", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_discriminative_copy_egs_tool.
@tool("nnet3-discriminative-copy-egs")
def nnet3_discriminative_copy_egs_tool(argv):
    """Copy (head-subset with --n) discriminative egs
    (nnet3bin/nnet3-discriminative-copy-egs.cc)."""
    po = ParseOptions("nnet3-discriminative-copy-egs [--n=0] "
                      "<degs-rspec> <degs-wspec>")
    po.register("n", int, 0, "copy only the first n (0 = all)")
    args = po.read(argv)
    n = 0
    with TableWriter(args[1], holder="deg") as w:
        for key, eg in SequentialTableReader(args[0], holder="deg"):
            if po["n"] and n >= po["n"]:
                break
            w[key] = eg
            n += 1
    log.info("nnet3-discriminative-copy-egs: copied %d", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_discriminative_shuffle_egs_tool.
@tool("nnet3-discriminative-shuffle-egs")
def nnet3_discriminative_shuffle_egs_tool(argv):
    """Randomize discriminative egs order
    (nnet3bin/nnet3-discriminative-shuffle-egs.cc)."""
    po = ParseOptions("nnet3-discriminative-shuffle-egs [--srand=0] "
                      "<degs-rspec> <degs-wspec>")
    po.register("srand", int, 0, "shuffle seed")
    args = po.read(argv)
    entries = list(SequentialTableReader(args[0], holder="deg"))
    rng = np.random.default_rng(po["srand"])
    rng.shuffle(entries)
    with TableWriter(args[1], holder="deg") as w:
        for key, eg in entries:
            w[key] = eg
    log.info("nnet3-discriminative-shuffle-egs: %d egs", len(entries))
    return 0


# Port of kaldi_tpu/cli/tools_bank16.py _read_raw_auto.
def _read_raw_auto(path: str, device, frame_subsampling_factor: int = 1):
    """Raw nnet3 file → (TdnnChain on ``device`` in eval mode, its
    TdnnConfig at ``frame_subsampling_factor``)."""
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    from kaldi_tpu_torch.am.tdnn import TdnnChain
    model = read_nnet3_path(path)
    cfg = infer_tdnn_config(model, frame_subsampling_factor)
    net = TdnnChain(cfg)
    net.load_state_dict(nnet3_to_state_dict(model, cfg))
    return net.eval().to(device), cfg


# Port of kaldi_tpu/cli/tools_bank16.py nnet3_discriminative_train_tool.
@tool("nnet3-discriminative-train")
def nnet3_discriminative_train_tool(argv):
    """MMI/sMBR sequence training from discriminative egs
    (nnet3bin/nnet3-discriminative-train.cc): per-eg adam steps on
    −objf, acoustics re-derived from the CURRENT model each pass (the
    reference recomputes nnet outputs per minibatch too)."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.pipelines.discriminative import (adam, eg_tensors,
                                                          sequence_step)
    po = ParseOptions("nnet3-discriminative-train [opts] <raw-in> "
                      "<degs-rspec> <raw-out>")
    po.register("criterion", str, "smbr", "smbr|mmi")
    po.register("num-epochs", int, 2, "epochs over the egs")
    po.register("learning-rate", float, 5e-5, "adam lr")
    po.register("acoustic-scale", float, 0.1, "kappa")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    net, cfg = _read_raw_auto(args[0], device)
    kappa = po["acoustic-scale"]
    crit = po["criterion"]
    if crit not in ("smbr", "mmi"):
        raise KaldiError(f"unknown criterion {crit}")
    opt = adam(net, po["learning-rate"])
    egs = [(key, eg_tensors(eg, crit, device)) for key, eg in
           SequentialTableReader(args[1], holder="deg")]
    if not egs:
        raise KaldiError("nnet3-discriminative-train: no egs")
    for ep in range(po["num-epochs"]):
        tot = 0.0
        for key, (x, num, acc, lat) in egs:
            tot += float(sequence_step(net, opt, crit, x, num, acc, lat,
                                       kappa))
        log.info("nnet3-discriminative-train: epoch %d %s objf/utt "
                 "%.6f", ep, crit, tot / len(egs))
    write_raw_model(args[2], net.state_dict(), cfg)
    return 0


# Port of kaldi_tpu/cli/tools_bank16.py nnet3_discriminative_compute_objf_tool.
@tool("nnet3-discriminative-compute-objf")
def nnet3_discriminative_compute_objf_tool(argv):
    """Report the sequence objective of a model on discriminative egs
    (nnet3bin/nnet3-discriminative-compute-objf.cc)."""
    from kaldi_tpu_torch.pipelines.discriminative import (eg_tensors,
                                                          sequence_objf)
    po = ParseOptions("nnet3-discriminative-compute-objf [opts] "
                      "<raw-in> <degs-rspec>")
    po.register("criterion", str, "smbr", "smbr|mmi")
    po.register("acoustic-scale", float, 0.1, "kappa")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    net, _cfg = _read_raw_auto(args[0], device)
    kappa = po["acoustic-scale"]
    tot, n = 0.0, 0
    with torch.no_grad():
        for _key, eg in SequentialTableReader(args[1], holder="deg"):
            x, num, acc, lat = eg_tensors(eg, po["criterion"], device)
            scores = torch.log_softmax(net(x[None])[0], dim=-1)
            tot += float(sequence_objf(po["criterion"], lat, scores, num,
                                       acc, kappa))
            n += 1
    print(f"objf-per-utt {tot / max(n, 1):.6f} over {n} egs")
    log.info("nnet3-discriminative-compute-objf: %s %.4f over %d",
             po["criterion"], tot / max(n, 1), n)
    return 0


# Port of kaldi_tpu/cli/tools_bank16.py decode_faster_mapped_tool.
@tool("decode-faster-mapped")
def decode_faster_mapped_tool(argv):
    """Best-path decoding from loglike matrices
    (bin/decode-faster-mapped.cc)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    po = ParseOptions("decode-faster-mapped [opts] <trans-model> <fst> "
                      "<loglikes-rspec> <words-wspec> [<ali-wspec>]")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    HCLG = _load_hclg(args[1])
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array, DenseDecoderConfig(
        beam=po["beam"], acoustic_scale=po["acoustic-scale"]),
        device=device)
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    awriter = (TableWriter(args[4], holder="ivec")
               if len(args) > 4 else None)
    n = 0
    with TableWriter(args[3], holder="text") as w:
        for key, ll in SequentialTableReader(args[2], holder="mat"):
            tids, ols, _cost = dec.decode(np.asarray(ll, np.float32))
            w[key] = [words_tab.find(o) if words_tab else str(o)
                      for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("decode-faster-mapped: decoded %d utterances", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_chain_subset_egs_tool.
@tool("nnet3-chain-subset-egs")
def nnet3_chain_subset_egs_tool(argv):
    """Random subset of chain egs (chainbin role; the get_egs.sh
    valid/train-diagnostic subsets)."""
    po = ParseOptions("nnet3-chain-subset-egs [--n=10] [--srand=0] "
                      "<cegs-rspec> <cegs-wspec>")
    po.register("n", int, 10, "subset size")
    po.register("srand", int, 0, "seed")
    args = po.read(argv)
    entries = list(SequentialTableReader(args[0], holder="ceg"))
    rng = np.random.default_rng(po["srand"])
    idx = rng.permutation(len(entries))[:po["n"]]
    with TableWriter(args[1], holder="ceg") as w:
        for i in sorted(idx):
            key, eg = entries[i]
            w[key] = eg
    log.info("nnet3-chain-subset-egs: kept %d of %d",
             min(po["n"], len(entries)), len(entries))
    return 0


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_chain_make_den_fst_tool.
@tool("nnet3-chain-make-den-fst")
def nnet3_chain_make_den_fst_tool(argv):
    """Build + serialize the chain denominator graph from training
    phone sequences (chainbin/nnet3-chain-make-den-fst.cc writes
    den.fst/normalization.fst; one file here carries the flat arc
    arrays plus stationary-distribution initial probs)."""
    from kaldi_tpu_torch.am.chain import (make_denominator_graph,
                                          write_denominator_graph)
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("nnet3-chain-make-den-fst [opts] <trans-model> "
                      "<phone-seqs-rspec> <den-out>")
    po.register("lm-order", int, 3, "den phone-LM order")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    seqs = [[int(x) for x in v] for _, v in
            SequentialTableReader(args[1], holder="ivec")]
    den = make_denominator_graph(seqs, tm.tree, tm.topo,
                                 order=po["lm-order"])
    with kio.open_wxfilename(args[2]) as f:
        kio.init_kaldi_output_stream(f)
        write_denominator_graph(f, den)
    log.info("nnet3-chain-make-den-fst: %d states, %d arcs (order %d)",
             den.num_states, len(den.src), po["lm-order"])
    return 0


def _flax_leaves(tree, path=()):
    """(path, leaf) of a nested dict in jax.tree_util's order (keys
    sorted at every level)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flax_leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


# Port of kaldi_tpu/cli/tools_bank16.py nnet3_show_progress_tool.
@tool("nnet3-show-progress")
def nnet3_show_progress_tool(argv):
    """Per-component parameter change between two models
    (nnet3bin/nnet3-show-progress.cc: relative l2 of the diff)."""
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    from kaldi_tpu_torch.am.tdnn import params_to_flax
    po = ParseOptions("nnet3-show-progress <raw-old> <raw-new>")
    args = po.read(argv)
    params, cfgs = [], []
    for path in args[:2]:
        model = read_nnet3_path(path)
        cfg = infer_tdnn_config(model, frame_subsampling_factor=1)
        params.append(params_to_flax(nnet3_to_state_dict(model,
                                                         cfg))["params"])
        cfgs.append(cfg)
    if cfgs[0] != cfgs[1]:
        raise KaldiError("nnet3-show-progress: model topologies differ")
    flat_new = dict(_flax_leaves(params[1]))
    for path, old in _flax_leaves(params[0]):
        new = flat_new[path]
        name = "/".join(path)
        denom = float(np.linalg.norm(old)) + 1e-20
        rel = float(np.linalg.norm(np.asarray(new)
                                   - np.asarray(old))) / denom
        print(f"{name}: rel-param-change {rel:.6f}")
    return 0
