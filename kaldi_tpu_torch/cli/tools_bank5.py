"""Port of kaldi_tpu/cli/tools_bank5.py: gmm-init-mono, the tree tools,
gmm-compute-likes, compose-transforms, the global (one-pdf) GMMs and
chain-est-phone-lm (chainbin/chain-est-phone-lm.cc; host numpy, copied).

Port of the tools of kaldi_tpu/cli/tools_bank5.py (parity targets
gmmbin/gmm-init-mono.cc, bin/acc-tree-stats.cc, sum-tree-stats.cc,
cluster-phones.cc, compile-questions.cc, build-tree.cc,
gmmbin/gmm-init-model.cc, gmm-compute-likes.cc,
featbin/compose-transforms.cc, gmmbin/gmm-global-init-from-feats.cc,
gmm-global-acc-stats.cc, gmm-global-est.cc, gmm-global-get-post.cc),
registered in cli/tools.py's ``TOOLS``.  The flat start, the tree
statistics, questions and tree, gmm-init-model's single Gaussians and
compose-transforms are host numpy (``AmDiagGmm.flat_start``,
``global_stats``, pipelines/tri.py, am/tree.py, am/transforms.py), as
in the original, and take no ``--device``.  gmm-compute-likes takes
``--device`` (default cuda): its output rows are the GMM kernel's, and
it logs the kernel's launches.  A global GMM is the port's
``AmDiagGmm`` with one pdf: the tools that compute with it take
``--device``, where its EM accumulation and posteriors run as tensor
ops (am/gmm.py ``accumulate_stats_device``, ``component_posteriors``).
The GMM kernel runs once, for gmm-global-init-from-feats's closing
like/frame log line, which also logs the kernel's launches.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


@tool("gmm-init-mono")
def gmm_init_mono_tool(argv):
    from kaldi_tpu_torch.am.gmm import AmDiagGmm, global_stats
    from kaldi_tpu_torch.am.serialize import (read_topology, write_mdl,
                                              write_tree)
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("gmm-init-mono [--train-feats=rspec] "
                      "[--perturb-factor=0] <topo-in> <dim> <model-out> "
                      "<tree-out>")
    po.register("train-feats", str, "",
                "features for the global mean/var flat start")
    po.register("perturb-factor", float, 0.0, "mean perturbation")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        topo = read_topology(f)
    dim = int(args[1])
    if po["train-feats"]:
        feats = [np.asarray(m) for _, m in
                 SequentialTableReader(po["train-feats"], holder="mat")]
        gmean, gvar = global_stats(feats)
    else:
        gmean, gvar = np.zeros(dim), np.ones(dim)
    tree = MonophoneContextDependency(topo.phones, topo)
    tm = TransitionModel(topo, tree)
    am = AmDiagGmm.flat_start(tree.num_pdfs, gmean, gvar,
                              perturb=po["perturb-factor"], device="cpu")
    write_mdl(args[2], tm, am)
    with kio.open_wxfilename(args[3]) as f:
        write_tree(f, tree)
    log.info("gmm-init-mono: %d pdfs dim %d", tree.num_pdfs, dim)
    return 0


# ---------------------------------------------------------------------------
# tree building (bin/; host code, copied)
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank5.py acc_tree_stats_tool.
@tool("acc-tree-stats")
def acc_tree_stats_tool(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.tree import write_tree_stats
    from kaldi_tpu_torch.pipelines.tri import accumulate_tree_stats
    po = ParseOptions("acc-tree-stats [--context-width=3] "
                      "[--central-position=1] <model> <feats-rspec> "
                      "<ali-rspec> <tree-accs-out>")
    po.register("context-width", int, 3, "phone context window")
    po.register("central-position", int, 1, "central phone position")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    feats = {k: np.asarray(v) for k, v in
             SequentialTableReader(args[1], holder="mat")}
    alis = {k: [int(x) for x in v] for k, v in
            SequentialTableReader(args[2], holder="ivec")}
    both = {k: feats[k] for k in feats if k in alis}
    stats = accumulate_tree_stats(both, {k: alis[k] for k in both}, tm,
                                  po["context-width"],
                                  po["central-position"])
    write_tree_stats(args[3], stats)
    log.info("acc-tree-stats: %d events from %d utterances",
             len(stats), len(both))
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py sum_tree_stats_tool.
@tool("sum-tree-stats")
def sum_tree_stats_tool(argv):
    from kaldi_tpu_torch.am.tree import (read_tree_stats, sum_tree_stats,
                                         write_tree_stats)
    po = ParseOptions("sum-tree-stats <tree-accs-out> <tree-accs-in1> ...")
    args = po.read(argv)
    write_tree_stats(args[0],
                     sum_tree_stats(read_tree_stats(p) for p in args[1:]))
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py _write_phone_sets.
def _write_phone_sets(path: str, sets) -> None:
    with open(path, "w") as f:
        for s in sets:
            f.write(" ".join(str(p) for p in sorted(s)) + "\n")


# Copied from kaldi_tpu/cli/tools_bank5.py _read_phone_sets.
def _read_phone_sets(path: str):
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(frozenset(int(x) for x in line.split()))
    return out


# Copied from kaldi_tpu/cli/tools_bank5.py cluster_phones_tool.
@tool("cluster-phones")
def cluster_phones_tool(argv):
    from kaldi_tpu_torch.am.tree import read_tree_stats
    from kaldi_tpu_torch.pipelines.tri import cluster_phone_questions
    po = ParseOptions("cluster-phones [--central-position=1] "
                      "<tree-stats-in> <phone-sets-out>")
    po.register("central-position", int, 1, "central phone position")
    args = po.read(argv)
    stats = read_tree_stats(args[0])
    questions = cluster_phone_questions(stats, po["central-position"])
    _write_phone_sets(args[1], questions)
    log.info("cluster-phones: %d phone sets", len(questions))
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py compile_questions_tool.
@tool("compile-questions")
def compile_questions_tool(argv):
    po = ParseOptions("compile-questions <phone-sets-in> <questions-out> "
                      "(adds singleton sets; text phone-set lines)")
    args = po.read(argv)
    sets = _read_phone_sets(args[0])
    phones = sorted({p for s in sets for p in s})
    for p in phones:
        if frozenset([p]) not in sets:
            sets.append(frozenset([p]))
    _write_phone_sets(args[1], sets)
    log.info("compile-questions: %d questions over %d phones",
             len(sets), len(phones))
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py build_tree_tool.
@tool("build-tree")
def build_tree_tool(argv):
    from kaldi_tpu_torch.am.serialize import write_tree
    from kaldi_tpu_torch.am.tree import build_tree, read_tree_stats
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("build-tree [--max-leaves=1000] [--thresh=0] "
                      "[--context-width=3] [--central-position=1] "
                      "<tree-stats-in> <questions-in> <tree-out>")
    po.register("max-leaves", int, 1000, "max pdf leaves")
    po.register("thresh", float, 0.0, "min likelihood-gain to split")
    po.register("context-width", int, 3, "phone context window")
    po.register("central-position", int, 1, "central phone position")
    args = po.read(argv)
    stats = read_tree_stats(args[0])
    questions = _read_phone_sets(args[1])
    tree = build_tree(stats, questions, po["context-width"],
                      po["central-position"], po["max-leaves"],
                      po["thresh"])
    with kio.open_wxfilename(args[2]) as f:
        write_tree(f, tree)
    log.info("build-tree: %d leaves", tree.num_pdfs)
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py gmm_init_model_tool (the model
# is built on the CPU: its single Gaussians are host numpy).
@tool("gmm-init-model")
def gmm_init_model_tool(argv):
    from kaldi_tpu_torch.am.serialize import (read_topology, read_tree,
                                              write_mdl)
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import read_tree_stats
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.pipelines.tri import init_model_from_tree_stats
    po = ParseOptions("gmm-init-model <tree-in> <tree-stats-in> <topo-in> "
                      "<model-out>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        tree = read_tree(f)
    stats = read_tree_stats(args[1])
    with kio.open_rxfilename(args[2]) as f:
        kio.init_kaldi_input_stream(f)
        topo = read_topology(f)
    am = init_model_from_tree_stats(tree, stats, device="cpu")
    tm = TransitionModel(topo, tree)
    write_mdl(args[3], tm, am)
    log.info("gmm-init-model: %d pdfs", am.num_pdfs)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_compute_likes_tool.
@tool("gmm-compute-likes")
def gmm_compute_likes_tool(argv):
    """Each utterance's (T, P) log-likelihoods: the GMM kernel's rows on
    ``--device``."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions("gmm-compute-likes <model> <feats-rspec> "
                      "<loglikes-wspec>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    _, am = read_mdl(args[0], device=resolve_device(po["device"]))
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            w[key] = am.loglikes(np.asarray(feats)).cpu().numpy()
            n += 1
    log.info("gmm-compute-likes: %d utterances; GMM kernel launches %d", n,
             am.device_params().launches)
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py compose_transforms_tool.
@tool("compose-transforms")
def compose_transforms_tool(argv):
    from kaldi_tpu_torch.am.transforms import compose_transforms
    from kaldi_tpu_torch.core import io as kio
    po = ParseOptions("compose-transforms [--b-is-affine=false] <a-in> "
                      "<b-in> <out>  (result applies b then a)")
    po.register("b-is-affine", bool, False,
                "treat b's last column as an offset")
    args = po.read(argv)

    def load(path):
        with kio.open_rxfilename(path) as f:
            kio.init_kaldi_input_stream(f)
            return kio.read_matrix(f)

    c = compose_transforms(load(args[0]), load(args[1]),
                           b_is_affine=po["b-is-affine"])
    with kio.open_wxfilename(args[2]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, c)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py _write_global_gmm.
def _write_global_gmm(path: str, am) -> None:
    from kaldi_tpu_torch.am.serialize import write_am_diag_gmm
    from kaldi_tpu_torch.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        write_am_diag_gmm(f, am)


# Port of kaldi_tpu/cli/tools_bank5.py _read_global_gmm (+ device).
def _read_global_gmm(path: str, device="cuda"):
    from kaldi_tpu_torch.am.serialize import read_am_diag_gmm
    from kaldi_tpu_torch.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        return read_am_diag_gmm(f, device)


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_init_from_feats_tool.
@tool("gmm-global-init-from-feats")
def gmm_global_init_from_feats_tool(argv):
    from kaldi_tpu_torch.am.gmm import (AmDiagGmm, GmmAccs, accumulate_stats,
                                        global_stats, mixup, mle_update)
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    po = ParseOptions("gmm-global-init-from-feats [--num-gauss=100] "
                      "[--num-iters=20] <feats-rspec> <gmm-out>")
    po.register("num-gauss", int, 100, "target mixture size")
    po.register("num-iters", int, 20, "EM iterations")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    feats = np.concatenate([np.asarray(m) for _, m in
                            SequentialTableReader(args[0], holder="mat")])
    gmean, gvar = global_stats([feats])
    am = AmDiagGmm.flat_start(1, gmean, gvar, device=device)
    pdf_ali = np.zeros(len(feats), np.int32)
    target = po["num-gauss"]
    for it in range(po["num-iters"]):
        # grow the mixture over the first half of the iterations
        want = min(target, 1 + (target * (it + 1) * 2)
                   // max(po["num-iters"], 1))
        if am.num_gauss() < want:
            am = mixup(am, want)
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        accumulate_stats(am, feats, pdf_ali, accs)
        mle_update(am, accs)
    _write_global_gmm(args[1], am)
    log.info("gmm-global-init-from-feats: %d gaussians on %d frames, "
             "like/frame %.4f; GMM kernel launches %d", am.num_gauss(),
             len(feats), float(am.loglikes(feats)[:, 0].mean()),
             CudaGmm.total_launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_acc_stats_tool.
@tool("gmm-global-acc-stats")
def gmm_global_acc_stats_tool(argv):
    from kaldi_tpu_torch.am.gmm import GmmAccs, accumulate_stats
    from kaldi_tpu_torch.cli.tools_extra import write_gmm_accs
    po = ParseOptions("gmm-global-acc-stats <gmm-in> <feats-rspec> "
                      "<accs-out>")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    am = _read_global_gmm(args[0], resolve_device(po["device"]))
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        feats = np.asarray(feats)
        accumulate_stats(am, feats, np.zeros(len(feats), np.int32), accs)
        n += 1
    write_gmm_accs(args[2], accs)
    log.info("gmm-global-acc-stats: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_est_tool.
@tool("gmm-global-est")
def gmm_global_est_tool(argv):
    from kaldi_tpu_torch.am.gmm import mixup, mle_update
    from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
    po = ParseOptions("gmm-global-est [--mix-up=0] <gmm-in> <accs-in> "
                      "<gmm-out>")
    po.register("mix-up", int, 0, "grow mixture to this size after update")
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    # host numpy updates, as the original: the model is read on the CPU
    am = _read_global_gmm(args[0], "cpu")
    accs = read_gmm_accs(args[1])
    mle_update(am, accs)
    if po["mix-up"] > am.num_gauss():
        am = mixup(am, po["mix-up"])
    _write_global_gmm(args[2], am)
    return 0


# Port of kaldi_tpu/cli/tools_bank5.py gmm_global_get_post_tool.
@tool("gmm-global-get-post")
def gmm_global_get_post_tool(argv):
    po = ParseOptions("gmm-global-get-post [--n=10] <gmm-in> <feats-rspec> "
                      "<post-wspec>")
    po.register("n", int, 10, "top-n gaussians per frame")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 3:
        po.print_usage()
        return 1
    am = _read_global_gmm(args[0], resolve_device(po["device"]))
    topn = po["n"]
    with TableWriter(args[2], holder="post") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            feats = np.asarray(feats)
            comp = am.component_posteriors(
                feats, np.zeros(len(feats), np.int32)).cpu().numpy()
            out = []
            for row in comp:
                idx = np.argsort(-row)[:topn]
                tot = float(row[idx].sum())
                out.append([(int(i), float(row[i]) / max(tot, 1e-20))
                            for i in idx])
            w[key] = out
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py chain_est_phone_lm_tool.
@tool("chain-est-phone-lm")
def chain_est_phone_lm_tool(argv):
    from kaldi_tpu_torch.am.chain import estimate_phone_lm, write_phone_lm
    po = ParseOptions("chain-est-phone-lm [--ngram-order=4] "
                      "<phone-seqs-rspec> <phone-lm-out>  (phone seqs = "
                      "ali-to-phones output)")
    po.register("ngram-order", int, 4, "n-gram order")
    args = po.read(argv)
    seqs = [[int(x) for x in v] for _, v in
            SequentialTableReader(args[0], holder="ivec")]
    phones = sorted({p for s in seqs for p in s})
    lm = estimate_phone_lm(seqs, phones, order=po["ngram-order"])
    write_phone_lm(args[1], lm)
    log.info("chain-est-phone-lm: order %d, %d states over %d phones "
             "from %d sequences", po["ngram-order"], lm.num_states,
             len(phones), len(seqs))
    return 0
