"""The tools of Kaldi's chain training loop (steps/nnet3/chain/train.py)
in the port, each held against the JAX package's tool of the same name
on the same files; the dense-target egs; and the JAX package's orbax
checkpoints read by the port.

The fixture writes a 3-phone chain model (a monophone tree and a flat
GMM, as ``.mdl``), seeded phone sequences and features, chain egs with
their segments and normalization weights (``make_chain_egs`` of the JAX
package), two raw TDNN-F models of one shape with seeded weights, an
nnet3 ``.mdl`` (the JAX package's nnet3-am-init) and pdf counts.  Host
tools give equal files; the tools that compute with tensors run on the
CPU (``--device=cpu``) and agree within 1e-5 of the largest value.
"""

import io
import re

import numpy as np
import pytest
import torch

import kaldi_tpu.cli  # noqa: F401  (registers the JAX tools)
import kaldi_tpu_torch.cli  # noqa: F401  (registers the port's tools)
from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.table import SequentialTableReader

torch.set_num_threads(1)

PHONES = [1, 2, 3]
D = 6
WIDTH = dict(hidden_dim=8, bottleneck_dim=4, num_layers=2)


def run(d, name, args, port_opts=(), capsys=None):
    """``name`` on both registries; ``{out}`` in args → a per-side path.
    → (port output, JAX output), or their stdout with ``capsys``."""
    outs = {}
    for side, main, extra in (("port", ttools.main, list(port_opts)),
                              ("jax", jtools.main, [])):
        out = str(d / f"{name}.{side}")
        if capsys is not None:
            capsys.readouterr()
        assert main([name, *extra,
                     *[a.format(d=d, out=out) for a in args]]) == 0, side
        outs[side] = capsys.readouterr().out if capsys else out
    return outs["port"], outs["jax"]


def same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(
        float(np.abs(want).max()), 1e-12)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from kaldi_tpu.am import (HmmTopology, MonophoneContextDependency,
                              TransitionModel)
    from kaldi_tpu.am.gmm import AmDiagGmm
    from kaldi_tpu.am.chain import (make_denominator_graph,
                                    write_denominator_graph)
    from kaldi_tpu.am.nnet3_io import write_raw_model
    from kaldi_tpu.am.serialize import write_mdl
    from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu.core import io as kio
    from kaldi_tpu.core.table import TableWriter
    from kaldi_tpu.pipelines.chain import make_chain_egs
    from kaldi_tpu.pipelines.egs_io import write_egs_ark
    import jax
    d = tmp_path_factory.mktemp("chainloop")
    rng = np.random.default_rng(0)
    topo = HmmTopology.chain(PHONES)
    tree = MonophoneContextDependency(PHONES, topo)
    tm = TransitionModel(topo, tree)
    write_mdl(str(d / "0.mdl"), tm, AmDiagGmm.flat_start(
        tree.num_pdfs, np.zeros(D), np.ones(D)))
    seqs = [[int(p) for p in rng.integers(1, 4, int(rng.integers(3, 8)))]
            for _ in range(12)]
    with TableWriter(f"ark:{d}/phones.ark", holder="ivec") as w:
        for i, s in enumerate(seqs):
            w[f"u{i}"] = np.asarray(s, np.int32)
    den = make_denominator_graph(seqs, tree, topo, order=2)
    with kio.open_wxfilename(str(d / "den.fst")) as f:
        kio.init_kaldi_output_stream(f)
        write_denominator_graph(f, den)
    feats, runs = {}, {}
    for i, s in enumerate(seqs):
        r = [(p, int(rng.integers(4, 10))) for p in s]
        runs[f"u{i}"] = r
        feats[f"u{i}"] = rng.standard_normal(
            (sum(n for _, n in r), D)).astype(np.float32)
    egs = make_chain_egs(feats, runs, tree, topo, chunk_size=12,
                         subsample=3, den=den)
    write_egs_ark(f"ark:{d}/egs.ark", egs)
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w, \
            TableWriter(f"ark:{d}/targets.ark", holder="mat") as t:
        for k in sorted(feats):
            w[k] = feats[k]
            t[k] = np.tanh(feats[k][:, :3])
    # three utterances of one length: the JAX tool compiles once a length
    with TableWriter(f"ark:{d}/post_feats.ark", holder="mat") as w:
        for k in sorted(feats)[:3]:
            w[k] = feats[k][:21]
    cfg = TdnnConfig(feat_dim=D, num_pdfs=tree.num_pdfs,
                     frame_subsampling_factor=3, **WIDTH)
    variables = TdnnChain(cfg).init(jax.random.PRNGKey(0),
                                    np.zeros((1, 12, D), np.float32),
                                    train=False)
    for m in range(2):
        mrng = np.random.default_rng(10 + m)
        params = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + 0.3 * mrng.standard_normal(
                np.shape(a))).astype(np.float32), variables["params"])
        stats = jax.tree_util.tree_map(np.asarray,
                                       variables["batch_stats"])
        write_raw_model(str(d / f"m{m}.raw"), params, stats, cfg)
    assert jtools.main(["nnet3-am-init", str(d / "0.mdl"),
                        str(d / "m0.raw"), str(d / "final.mdl")]) == 0
    with kio.open_wxfilename(str(d / "counts.vec")) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_vector(f, rng.integers(0, 50, tree.num_pdfs)
                         .astype(np.float32))
    return d


@pytest.mark.parametrize("name", ["chain-make-den-fst",
                                  "nnet3-chain-make-den-fst"])
def test_make_den_fst(files, name):
    p, j = run(files, name, ["--lm-order=2", "{d}/0.mdl",
                             "ark:{d}/phones.ark", "{out}"])
    assert same_bytes(p, j)


def test_chain_est_phone_lm(files):
    p, j = run(files, "chain-est-phone-lm",
               ["--ngram-order=3", "ark:{d}/phones.ark", "{out}"])
    assert same_bytes(p, j)


@pytest.mark.parametrize("name,args", [
    ("nnet3-chain-subset-egs", ["--n=5", "--srand=3"]),
    ("nnet3-chain-merge-egs", ["--minibatch-size=4"]),
    ("nnet3-chain-merge-egs", ["--minibatch-size=4",
                               "--discard-partial=true"])])
def test_egs_tools(files, name, args):
    p, j = run(files, name, [*args, "ark:{d}/egs.ark", "ark:{out}"])
    assert same_bytes(p, j)
    n = len(list(SequentialTableReader(f"ark:{p}", holder="ceg")))
    assert 0 < n <= 64


def test_normalize_egs(files):
    p, j = run(files, "nnet3-chain-normalize-egs",
               ["{d}/0.mdl", "{d}/den.fst", "ark:{d}/egs.ark", "ark:{out}"])
    assert same_bytes(p, j)
    before = [eg.init_w for _k, eg in
              SequentialTableReader(f"ark:{files}/egs.ark", holder="ceg")]
    after = [eg.init_w for _k, eg in
             SequentialTableReader(f"ark:{p}", holder="ceg")]
    assert len(after) == len(before) and np.all(np.isfinite(after))


def test_nnet3_average(files):
    p, j = run(files, "nnet3-average", ["{out}", "{d}/m0.raw",
                                        "{d}/m1.raw"])
    assert same_bytes(p, j)


@pytest.mark.parametrize("raw", ["false", "true"])
def test_nnet3_am_copy(files, raw):
    p, j = run(files, "nnet3-am-copy", [f"--raw={raw}", "{d}/final.mdl",
                                        "{out}"])
    assert same_bytes(p, j)


def test_nnet3_am_adjust_priors(files):
    p, j = run(files, "nnet3-am-adjust-priors",
               ["{d}/final.mdl", "{d}/counts.vec", "{out}"])
    assert same_bytes(p, j)


def test_nnet3_get_egs_dense_targets(files):
    """DenseEg archives equal byte for byte; the port reads the chunks
    back as the JAX package wrote them."""
    p, j = run(files, "nnet3-get-egs-dense-targets",
               ["--chunk-size=8", "ark:{d}/feats.ark", "ark:{d}/targets.ark",
                "ark:{out}"])
    assert same_bytes(p, j)
    egs = list(SequentialTableReader(f"ark:{j}", holder="dteg"))
    assert egs and all(eg.feats.shape == (8, D) and eg.targets.shape == (8, 3)
                       for _k, eg in egs)


def test_nnet3_show_progress(files, capsys):
    p, j = run(files, "nnet3-show-progress", ["{d}/m0.raw", "{d}/m1.raw"],
               capsys=capsys)
    pat = re.compile(r"^(\S+): rel-param-change (\S+)$")
    got = [pat.match(x).groups() for x in p.splitlines()]
    want = [pat.match(x).groups() for x in j.splitlines()]
    assert [g[0] for g in got] == [w[0] for w in want] and len(got) > 10
    for (_n, g), (_m, w) in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-5 * max(float(w), 1e-6) + 1e-6


def test_nnet3_chain_compute_post(files):
    p, j = run(files, "nnet3-chain-compute-post",
               ["{d}/m0.raw", "ark:{d}/post_feats.ark", "ark:{out}"],
               port_opts=["--device=cpu"])
    got = dict(SequentialTableReader(f"ark:{p}", holder="mat"))
    want = dict(SequentialTableReader(f"ark:{j}", holder="mat"))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
        np.testing.assert_allclose(got[k].sum(-1), 1.0, rtol=1e-5)


def test_nnet3_chain_combine(files, caplog):
    """The combined model within 1e-5 of the JAX tool's (Adam over the
    two models' combination logits, the LF-MMI objective on the egs)."""
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    p, j = run(files, "nnet3-chain-combine",
               ["--num-iters=6", "{d}/den.fst", "ark:{d}/egs.ark",
                "{d}/m0.raw", "{d}/m1.raw", "{out}"],
               port_opts=["--device=cpu"])
    sides = []
    for path in (p, j):
        model = read_nnet3_path(path)
        sides.append(nnet3_to_state_dict(model, infer_tdnn_config(model)))
    assert sorted(sides[0]) == sorted(sides[1])
    for k, want in sides[1].items():
        _close(sides[0][k].numpy(), want.numpy())
    # the weights moved off the even mix
    m0 = nnet3_to_state_dict(read_nnet3_path(str(files / "m0.raw")),
                             infer_tdnn_config(read_nnet3_path(
                                 str(files / "m0.raw"))))
    m1 = nnet3_to_state_dict(read_nnet3_path(str(files / "m1.raw")),
                             infer_tdnn_config(read_nnet3_path(
                                 str(files / "m1.raw"))))
    k = "output_affine.weight"
    w0 = float(((sides[0][k] - m1[k]) / (m0[k] - m1[k])).median())
    assert abs(w0 - 0.5) > 0.05


def test_read_train_state_of_a_jax_checkpoint(tmp_path):
    """A directory the JAX ChainTrainer's ``train(ckpt_dir=)`` writes:
    ``read_train_state`` gives its params equal, and a port trainer
    restored from it scores within 1e-5 of the JAX model."""
    pytest.importorskip("tensorstore")
    from kaldi_tpu.am.chain import make_denominator_graph as jden
    from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
    from kaldi_tpu.am.topology import HmmTopology as JTopo
    from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
    from kaldi_tpu.pipelines.chain import (ChainEgs, ChainTrainConfig as JTC,
                                           ChainTrainer as JTrainer)
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.pipelines.chain import ChainTrainConfig, ChainTrainer
    from kaldi_tpu_torch.pipelines.checkpoint import (latest_step,
                                                      read_train_state)
    jtopo = JTopo.chain(PHONES)
    jtree = JMono(PHONES, jtopo)
    P = jtree.num_pdfs
    rng = np.random.default_rng(4)
    egs = ChainEgs(feats=rng.standard_normal((8, 12, D)).astype(np.float32),
                   pdf_ali=rng.integers(0, P, (8, 4)).astype(np.int32),
                   mask=np.ones((8, 4), bool))
    width = dict(feat_dim=D, num_pdfs=P, frame_subsampling_factor=3,
                 **WIDTH)
    jt = JTrainer(JCfg(**width), jden([[1, 2, 3], [3, 1]], jtree, jtopo),
                  JTC(num_epochs=2, batch_size=4, optimizer="ngsgd"), seed=3)
    jt.train(egs, ckpt_dir=str(tmp_path))
    assert latest_step(str(tmp_path)) == 4
    state = read_train_state(str(tmp_path))
    assert state["step"] == 4
    flat = jax_leaves(jt.params)
    got = dict(_walk(state["params"]))
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)
    for k, v in jax_leaves(jt.batch_stats).items():
        np.testing.assert_array_equal(dict(_walk(state["batch_stats"]))[k],
                                      v)
    assert isinstance(state["opt_state"], list)
    topo = HmmTopology.chain(PHONES)
    tree = MonophoneContextDependency(PHONES, topo)
    tr = ChainTrainer(TdnnConfig(**width),
                      make_denominator_graph([[1, 2, 3], [3, 1]], tree, topo),
                      ChainTrainConfig(optimizer="ngsgd"), device="cpu")
    assert tr.restore(str(tmp_path)) == 4
    want = np.asarray(jt.scores_fn()(egs.feats))
    _close(tr.scores_fn()(egs.feats).numpy(), want)
    assert float(np.abs(want).max()) > 0


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def jax_leaves(tree):
    import jax
    return {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_dteg_round_trip_in_memory():
    """write_dense_eg / read_dense_eg equal the JAX package's bytes."""
    from kaldi_tpu.pipelines.egs_io import write_dense_eg as jwrite
    from kaldi_tpu_torch.pipelines.egs_io import (DenseEg, read_dense_eg,
                                                  write_dense_eg)
    eg = DenseEg(np.arange(12, dtype=np.float32).reshape(4, 3),
                 np.ones((4, 2), np.float32))
    a, b = io.BytesIO(), io.BytesIO()
    write_dense_eg(a, eg)
    jwrite(b, eg)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    back = read_dense_eg(a)
    np.testing.assert_array_equal(back.feats, eg.feats)
    np.testing.assert_array_equal(back.targets, eg.targets)


@pytest.mark.parametrize("name,nargs", [("nnet3-chain-combine", 5),
                                        ("nnet3-chain-compute-post", 3)])
def test_tensor_tools_default_to_the_card(name, nargs, monkeypatch):
    """Without ``--device`` the tool asks for the card, and without one it
    raises before reading its inputs."""
    from kaldi_tpu_torch.core.logging import KaldiError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        ttools.TOOLS[name](["never.read"] * nargs)


def test_registry_holds_the_chain_loop():
    """The 13 tools are registered, each also a tool of the original
    (161 → 174 of the original's; 201 with the serving and regression-
    tree tools, tests/test_torch_serve_tools.py; 234 with the nnet2
    tools, tests/test_torch_nnet2_tools.py; 277 with the nnet1 and nnet3
    loop tools)."""
    loop = {"nnet3-get-egs-dense-targets", "nnet3-chain-merge-egs",
            "nnet3-chain-normalize-egs", "nnet3-chain-combine",
            "nnet3-chain-compute-post", "nnet3-am-adjust-priors",
            "nnet3-chain-subset-egs", "nnet3-chain-make-den-fst",
            "nnet3-show-progress", "nnet3-average", "chain-est-phone-lm",
            "chain-make-den-fst", "nnet3-am-copy"}
    assert len(loop) == 13
    assert loop <= set(ttools.TOOLS) and loop <= set(jtools.TOOLS)
    assert len(ttools.TOOLS) == 277


def test_checkpoint_module_names_its_original():
    import os
    import kaldi_tpu_torch.pipelines.checkpoint as ck
    with open(ck.__file__) as f:
        first = f.readline()
    assert "kaldi_tpu/pipelines/checkpoint.py" in first, first
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.isfile(os.path.join(repo, "kaldi_tpu", "pipelines",
                                       "checkpoint.py"))
