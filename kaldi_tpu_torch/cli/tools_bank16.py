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

The cross-entropy loop's tools of the same bank (parity targets
nnet3bin/{nnet3-combine, nnet3-subset-egs, nnet3-acc-lda-stats}.cc,
bin/align-mapped.cc): nnet3-subset-egs is host code, copied;
nnet3-acc-lda-stats sums the egs' frames in one
``LdaEstimate.accumulate_batch`` (the original adds them one frame at a
time: the same sums up to float64 order).  nnet3-combine and
align-mapped take ``--device``: the combination's Adam (optax's, as
pipelines/chain.py ``_adam``) over the softmax weight logits and the
models' forward run there, and ``DenseAligner`` aligns one utterance a
call there.  nnet3-combine is the original's: Adam(0.1) where Kaldi
runs L-BFGS (ROADMAP, "Reference faults to port to intent").
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


# ---------------------------------------------------------------------------
# Model combination, egs subsets, LDA stats and the mapped aligner of the
# cross-entropy loop.

def combine_xent(nets, feats, alis, num_iters: int, lr: float = 0.1):
    """nnet3-combine's optimization: every parameter of the combined
    model is Σ_i softmax(w)_i · model_i's, the batch-norm statistics the
    first model's, and step ``it`` of optax's Adam at ``lr`` from w = 0
    minimises the frame cross-entropy of utterance ``it % N`` (its
    features (T, D) and pdf targets as tensors on the models' device).
    With one model no step is taken.  → (the combined state dict, the
    weights)."""
    from kaldi_tpu_torch.pipelines.chain import _adam
    net = nets[0]
    device = next(net.parameters()).device
    stack = {k: torch.stack([dict(m.named_parameters())[k].detach()
                             for m in nets])
             for k, _ in net.named_parameters()}
    buffers = dict(net.named_buffers())

    def mix(logits):
        wts = torch.softmax(logits, dim=0)
        return {k: torch.tensordot(wts, s, dims=1) for k, s in stack.items()}

    logits = torch.zeros(len(nets), device=device)
    if len(nets) > 1:
        adam = _adam(lr)
        for it in range(num_iters):
            x, y = feats[it % len(feats)], alis[it % len(feats)]
            lg = logits.clone().requires_grad_(True)
            out = torch.func.functional_call(net, {**mix(lg), **buffers},
                                             (x[None],))[0]
            lp = torch.log_softmax(out, dim=-1)
            loss = -lp[torch.arange(y.shape[0], device=device), y].mean()
            (g,) = torch.autograd.grad(loss, lg)
            logits = logits + adam(g)
    with torch.no_grad():
        mixed = mix(logits)
    return {**mixed, **buffers}, torch.softmax(logits, 0).cpu().numpy()


# Port of kaldi_tpu/cli/tools_bank16.py nnet3_combine_tool.
@tool("nnet3-combine")
def nnet3_combine_tool(argv):
    """Combine models by objective-optimized softmax weights on
    validation examples, on ``--device`` (nnet3bin/nnet3-combine.cc:
    the reference optimizes combination weights with LBFGS on valid egs;
    here adam over the weight logits, xent objective)."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    po = ParseOptions("nnet3-combine [opts] <valid-feats-rspec> "
                      "<valid-pdf-ali-rspec> <raw-in1> [<raw-in2> ...] "
                      "<raw-out>")
    po.register("num-iters", int, 40, "weight-optimization steps")
    _device_po(po)
    args = po.read(argv)
    if len(args) < 4:
        raise KaldiError("nnet3-combine: need >=1 input model")
    device = resolve_device(po["device"])
    model_paths, out_path = args[2:-1], args[-1]
    loaded = [_read_raw_auto(p, device) for p in model_paths]
    cfg = loaded[0][1]
    ali_r = RandomAccessTableReader(args[1], holder="ivec")
    feats, alis = [], []
    for key, f in SequentialTableReader(args[0], holder="mat"):
        if key in ali_r:
            f = np.asarray(f, np.float32)
            feats.append(torch.tensor(f, device=device))
            alis.append(torch.tensor(np.asarray(ali_r[key], np.int64)
                                     [:len(f)], device=device))
    if not feats:
        raise KaldiError("nnet3-combine: no validation utterances")
    sd, wts = combine_xent([n for n, _c in loaded], feats, alis,
                           po["num-iters"])
    if len(loaded) > 1:
        log.info("nnet3-combine: weights %s", np.round(wts, 3))
    write_raw_model(out_path, sd, cfg)
    return 0


# Copied from kaldi_tpu/cli/tools_bank16.py nnet3_subset_egs_tool.
@tool("nnet3-subset-egs")
def nnet3_subset_egs_tool(argv):
    """Random subset of xent egs (nnet3bin/nnet3-subset-egs.cc)."""
    po = ParseOptions("nnet3-subset-egs [--n=10] [--srand=0] "
                      "<egs-rspec> <egs-wspec>")
    po.register("n", int, 10, "subset size")
    po.register("srand", int, 0, "seed")
    args = po.read(argv)
    entries = list(SequentialTableReader(args[0], holder="xeg"))
    rng = np.random.default_rng(po["srand"])
    idx = rng.permutation(len(entries))[:po["n"]]
    with TableWriter(args[1], holder="xeg") as w:
        for i in sorted(idx):
            key, eg = entries[i]
            w[key] = eg
    log.info("nnet3-subset-egs: kept %d of %d", min(po["n"],
             len(entries)), len(entries))
    return 0


def write_lda_accs(path: str, lda) -> None:
    """An ``LdaEstimate``'s sums as acc-lda writes them (``<LDAACCS>``;
    sum-lda-accs and est-lda read them)."""
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<LDAACCS>")
        kio.write_matrix(f, lda.counts[None, :])
        kio.write_matrix(f, lda.first)
        kio.write_matrix(f, lda.total_second)
        kio.write_token(f, "</LDAACCS>")


# Port of kaldi_tpu/cli/tools_bank16.py nnet3_acc_lda_stats_tool.
@tool("nnet3-acc-lda-stats")
def nnet3_acc_lda_stats_tool(argv):
    """Accumulate LDA stats from xent egs — the preconditioning
    LDA-like transform of the nnet3 recipes
    (nnet3bin/nnet3-acc-lda-stats.cc).  Acc file format matches
    acc-lda / est-lda (sum-lda-accs composes)."""
    from kaldi_tpu_torch.am.transforms import LdaEstimate
    po = ParseOptions("nnet3-acc-lda-stats [--num-pdfs=N] <egs-rspec> "
                      "<acc-out>")
    po.register("num-pdfs", int, 0, "target count (0 = max seen + 1)")
    args = po.read(argv)
    chunks = list(SequentialTableReader(args[0], holder="xeg"))
    if not chunks:
        raise KaldiError("nnet3-acc-lda-stats: no egs")
    num_pdfs = po["num-pdfs"] or (
        max(int(eg.pdfs.max()) for _k, eg in chunks) + 1)
    dim = chunks[0][1].feats.shape[-1]
    lda = LdaEstimate(num_pdfs, dim)
    lda.accumulate_batch(
        np.concatenate([np.asarray(eg.feats, np.float64).reshape(-1, dim)
                        for _k, eg in chunks]),
        np.concatenate([np.asarray(eg.pdfs).reshape(-1)
                        for _k, eg in chunks]))
    write_lda_accs(args[1], lda)
    log.info("nnet3-acc-lda-stats: %d chunks, %d classes, dim %d",
             len(chunks), num_pdfs, dim)
    return 0


# Port of kaldi_tpu/cli/tools_bank16.py align_mapped_tool.
@tool("align-mapped")
def align_mapped_tool(argv):
    """Forced alignment from loglike matrices + compiled training
    graphs on ``--device`` (bin/align-mapped.cc)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_bank28 import (align_compiled,
                                                  mapped_loglikes)
    po = ParseOptions("align-mapped [opts] <trans-model> <graphs-rspec> "
                      "<loglikes-rspec> <ali-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    align_compiled("align-mapped", tm.tid_to_pdf_array, args[1],
                   mapped_loglikes(args[2]), args[3], po["acoustic-scale"],
                   device)
    return 0
