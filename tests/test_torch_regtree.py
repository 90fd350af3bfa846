"""Regression-tree MLLR / fMLLR in the port (am/regtree.py) against
kaldi_tpu/am/regtree.py, and the port's speaker-adapted GMM tools
(gmm-make-regtree, gmm-est-regtree-mllr, gmm-est-regtree-fmllr(-ali),
gmm-decode-faster-regtree-fmllr / -mllr,
gmm-latgen-faster-regtree-fmllr, gmm-latgen-map, gmm-rescore-lattice)
run through the port's registry with ``--device=cpu`` and held against
the JAX package's tools on the same files (the tools that
tests/test_cli_bank{7,10,12,17,22,27}.py and test_regtree.py cover in
the original).

The files are written once by a module fixture from seeded numpy draws:
a 3-word monophone GMM system (D = 4, 2 Gaussians a pdf), 6 utterances
of 2 speakers drawn around the means of random pdf sequences, and their
alignments from the dense decoder.  Bars: the tree equal; accumulators
within 1e-6 of their largest entry (the two packages' float32 mixture
posteriors differ in rounding); estimates from the same statistics and
files the tools write equal to 1e-6; fMLLR transforms from the tools
within 1e-4 (an iterative solve of those statistics); words equal, best
paths equal with costs within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.am import regtree as jrt
from kaldi_tpu.am.gmm import AmDiagGmm as JAm
from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am import regtree as trt
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)

CPU = ("--device=cpu",)
REL = 1e-4
ACC_TOL = 1e-6


def read(spec, holder):
    return dict(SequentialTableReader(spec, holder=holder))


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def same_best(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        assert list(gw) == list(ww), k
        assert gc == pytest.approx(wc, rel=REL, abs=REL)


@pytest.fixture(scope="module")
def rsys(tmp_path_factory):
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.fst import (ArpaModel, Lang, Lexicon, arpa_to_fst,
                                     make_unigram_arpa, mkgraph)
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    d = tmp_path_factory.mktemp("regtree")
    rng = np.random.default_rng(22)
    lang = Lang(Lexicon([("ONE", ["w", "n"]), ("TWO", ["t", "u"]),
                         ("NINE", ["n", "ai", "n"])]))
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tm = TransitionModel(topo, MonophoneContextDependency(phones, topo))
    P, M, D = tm.num_pdfs, 2, 4
    w = rng.dirichlet(np.ones(M), size=P)
    means = 1.5 * rng.standard_normal((P, M, D))
    var = 0.5 + rng.random((P, M, D))
    am = AmDiagGmm(w, means, var, device="cpu")
    write_mdl(f"{d}/final.mdl", tm, am)
    lang.words.write(f"{d}/words.txt")
    HCLG = mkgraph(lang, tm, arpa_to_fst(ArpaModel.parse(make_unigram_arpa(
        {"ONE": 1.0, "TWO": 1.0, "NINE": 1.0})), lang.words))
    write_fst_path(f"{d}/HCLG.fst", HCLG)
    mean = np.einsum("pm,pmd->pd", w, means)
    feats = {}
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as wr:
        for i in range(6):
            pdfs = np.repeat(rng.integers(0, P, 10), 5)
            # speaker 1's frames shifted: something for the transforms to
            # learn
            shift = 0.4 * (i % 2)
            feats[f"u{i}"] = (mean[pdfs] + shift + 0.3 * rng.standard_normal(
                (len(pdfs), D))).astype(np.float32)
            wr[f"u{i}"] = feats[f"u{i}"]
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=16.0, acoustic_scale=0.1),
                       device="cpu")
    alis = {}
    with TableWriter(f"ark:{d}/ali.ark", holder="ivec") as wr:
        for k, f in feats.items():
            alis[k] = np.asarray(dec.decode(am.loglikes(f))[0], np.int32)
            wr[k] = alis[k]
    with open(f"{d}/utt2spk", "w") as f:
        for i in range(6):
            f.write(f"u{i} s{i % 2}\n")
    with TableWriter(f"ark:{d}/none.ark", holder="mat"):
        pass                            # no speaker's transform
    with open(f"{d}/spk2utt", "w") as f:
        for s in range(2):
            f.write(f"s{s} " + " ".join(f"u{i}" for i in range(s, 6, 2))
                    + "\n")
    return {"d": str(d), "tm": tm, "am": am, "feats": feats, "alis": alis,
            "jam": JAm(w, means, var)}


def _pdfs(rsys, k):
    return rsys["tm"].tid_to_pdf_array[rsys["alis"][k]].astype(np.int32)


# ---------------------------------------------------------------------------
# am/regtree.py

@pytest.mark.parametrize("classes", [2, 3])
def test_tree_equals_jax(rsys, classes):
    got = trt.RegressionTree.build(rsys["am"], classes)
    want = jrt.RegressionTree.build(rsys["jam"], classes)
    assert got.children == want.children
    np.testing.assert_array_equal(got.bclass, want.bclass)
    np.testing.assert_array_equal(got.parents(), want.parents())


@pytest.mark.parametrize("kind", ["mllr", "fmllr"])
def test_accumulators_and_estimates_equal_jax(rsys, kind):
    Accs = {"mllr": (trt.RegtreeMllrAccs, jrt.RegtreeMllrAccs),
            "fmllr": (trt.RegtreeFmllrAccs, jrt.RegtreeFmllrAccs)}[kind]
    tree = trt.RegressionTree.build(rsys["am"], 3)
    jtree = jrt.RegressionTree.build(rsys["jam"], 3)
    got, want = Accs[0](tree, 4), Accs[1](jtree, 4)
    for k, f in rsys["feats"].items():
        got.accumulate(rsys["am"], f, _pdfs(rsys, k))
        want.accumulate(rsys["jam"], f, _pdfs(rsys, k))
    for name in ("K", "G", "beta"):
        close(getattr(got, name), getattr(want, name), ACC_TOL)
    # the estimate of the same statistics
    for name in ("K", "G", "beta"):
        setattr(got, name, getattr(want, name).copy())
    min_count = 20.0
    ge, we = got.estimate(min_count=min_count), want.estimate(
        min_count=min_count)
    close(ge.W, we.W, 1e-9)
    if kind == "mllr":
        close(ge.transform_model(rsys["am"]).means,
              we.transform_model(rsys["jam"]).means, 1e-9)
    else:
        close(ge.root_transform(), we.root_transform(), 1e-9)
    # merge sums
    twice = Accs[0](tree, 4)
    twice.K, twice.G, twice.beta = (got.K.copy(), got.G.copy(),
                                    got.beta.copy())
    twice.merge(got)
    close(twice.K, 2 * got.K, 1e-12)


def test_transform_model_is_a_new_model_on_the_device(rsys):
    tree = trt.RegressionTree.build(rsys["am"], 2)
    W = np.stack([np.concatenate([2 * np.eye(4), np.ones((4, 1))], 1)]
                 * tree.num_nodes)
    out = trt.RegtreeMllr(tree, W).transform_model(rsys["am"])
    assert out is not rsys["am"] and out.device == rsys["am"].device
    np.testing.assert_allclose(out.means, 2 * rsys["am"].means + 1)
    np.testing.assert_array_equal(out.vars, rsys["am"].vars)
    # the input model is untouched
    assert not np.allclose(rsys["am"].means, out.means)


def test_regtree_file_equals_jax(rsys):
    d = rsys["d"]
    tree = trt.RegressionTree.build(rsys["am"], 3)
    trt.write_regtree(f"{d}/port.tree", tree)
    jrt.write_regtree(f"{d}/jax.tree", jrt.RegressionTree.build(
        rsys["jam"], 3))
    with open(f"{d}/port.tree", "rb") as f, open(f"{d}/jax.tree",
                                                 "rb") as g:
        assert f.read() == g.read()
    back = trt.read_regtree(f"{d}/jax.tree")
    assert back.children == tree.children
    np.testing.assert_array_equal(back.bclass, tree.bclass)


# ---------------------------------------------------------------------------
# the tools

def run(rsys, name, args, jax=True, port_opts=CPU):
    outs = {}
    sides = [("port", ttools.main, list(port_opts))]
    if jax:
        sides.append(("jax", jtools.main, []))
    for side, main, extra in sides:
        out = f"{rsys['d']}/{name}.{side}"
        assert main([name, *extra, *[a.replace("{d}", rsys["d"])
                                     .replace("{out}", out)
                                     for a in args]]) == 0, side
        outs[side] = out
    return outs["port"], outs.get("jax")


def test_gmm_make_regtree(rsys):
    p, j = run(rsys, "gmm-make-regtree", ["--max-leaves=3",
                                          "{d}/final.mdl", "{out}"],
               port_opts=())
    with open(p, "rb") as f, open(j, "rb") as g:
        assert f.read() == g.read()


def test_gmm_est_regtree_mllr(rsys):
    p, j = run(rsys, "gmm-est-regtree-mllr",
               ["--num-base-classes=3", "--min-count=20", "{d}/final.mdl",
                "ark:{d}/feats.ark", "ark:{d}/ali.ark", "{out}"])
    _, got = read_mdl(p, device="cpu")
    _, want = read_mdl(j, device="cpu")
    close(got.means, want.means, 1e-5)
    np.testing.assert_array_equal(got.vars, want.vars)
    assert not np.allclose(got.means, rsys["am"].means)


@pytest.mark.parametrize("name", ["gmm-est-regtree-fmllr",
                                  "gmm-est-regtree-fmllr-ali"])
def test_gmm_est_regtree_fmllr(rsys, name):
    p, j = run(rsys, name, ["--num-base-classes=2", "--min-count=50",
                            "--spk2utt=ark,t:{d}/spk2utt", "{d}/final.mdl",
                            "ark:{d}/feats.ark", "ark:{d}/ali.ark",
                            "ark:{out}"])
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(want) == ["s0", "s1"]
    for k in want:
        close(got[k], want[k], REL)
        assert got[k].shape == (4, 5)


@pytest.fixture(scope="module")
def trans(rsys):
    """Each speaker's regtree fMLLR root transform (the port tool's
    file; both packages decode with it)."""
    d = rsys["d"]
    assert ttools.main(["gmm-est-regtree-fmllr", *CPU, "--min-count=50",
                        f"--spk2utt=ark,t:{d}/spk2utt", f"{d}/final.mdl",
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        f"ark:{d}/trans.ark"]) == 0
    return f"ark:{d}/trans.ark"


@pytest.mark.parametrize("name", ["gmm-decode-faster-regtree-fmllr",
                                  "gmm-decode-faster-regtree-mllr"])
def test_regtree_decodes(rsys, trans, name):
    p, j = run(rsys, name, ["--utt2spk=ark,t:{d}/utt2spk",
                            "--word-symbol-table={d}/words.txt",
                            "{d}/final.mdl", "{d}/HCLG.fst", trans,
                            "ark:{d}/feats.ark", "ark,t:{out}"])
    got, want = read(f"ark,t:{p}", "text"), read(f"ark,t:{j}", "text")
    assert got == want and any(got.values())


def test_gmm_latgen_faster_regtree_fmllr(rsys, trans):
    p, j = run(rsys, "gmm-latgen-faster-regtree-fmllr",
               ["--utt2spk=ark,t:{d}/utt2spk", "{d}/final.mdl",
                "{d}/HCLG.fst", trans, "ark:{d}/feats.ark", "ark:{out}"])
    same_best(read(f"ark:{p}", "clat"), read(f"ark:{j}", "clat"))


def test_gmm_latgen_map(rsys):
    p, j = run(rsys, "gmm-latgen-map",
               ["--mean-tau=5.0", "--utt2spk=ark,t:{d}/utt2spk",
                "{d}/final.mdl", "{d}/HCLG.fst", "ark:{d}/feats.ark",
                "ark:{d}/ali.ark", "ark:{out}"])
    got = read(f"ark:{p}", "clat")
    same_best(got, read(f"ark:{j}", "clat"))
    # adapted: not the unadapted decode's costs
    q, _ = run(rsys, "gmm-latgen-faster-regtree-fmllr",
               ["{d}/final.mdl", "{d}/HCLG.fst", "ark:{d}/none.ark",
                "ark:{d}/feats.ark", "ark:{out}"], jax=False)
    plain = read(f"ark:{q}", "clat")
    assert any(abs(got[k].best_path()[2] - plain[k].best_path()[2]) > 1e-3
               for k in got)


def test_gmm_rescore_lattice(rsys):
    """Rescoring the unadapted decode's lattices with the MLLR-adapted
    model equals the JAX tool and the adapted model's log-likelihoods
    on each arc's frames."""
    d = rsys["d"]
    q, _ = run(rsys, "gmm-latgen-faster-regtree-fmllr",
               ["{d}/final.mdl", "{d}/HCLG.fst", "ark:{d}/none.ark",
                "ark:{d}/feats.ark", "ark:{out}"], jax=False)
    assert ttools.main(["gmm-est-regtree-mllr", *CPU, "--min-count=20",
                        f"{d}/final.mdl", f"ark:{d}/feats.ark",
                        f"ark:{d}/ali.ark", f"{d}/mllr.mdl"]) == 0
    p, j = run(rsys, "gmm-rescore-lattice",
               ["{d}/mllr.mdl", f"ark:{q}", "ark:{d}/feats.ark",
                "ark:{out}"])
    got = read(f"ark:{p}", "clat")
    same_best(got, read(f"ark:{j}", "clat"))
    # each arc's acoustic cost: −Σ log p(x_t | pdf) under the adapted
    # model (the library) over the frames of its transition-ids
    from kaldi_tpu_torch.lattice.functions import state_times
    tm, am = read_mdl(f"{d}/mllr.mdl", device="cpu")
    for k, clat in got.items():
        ll = am.loglikes(rsys["feats"][k]).numpy().astype(np.float64)
        times = state_times(clat)
        for s in range(clat.num_states):
            for a in clat.arcs[s]:
                t = times[s] + np.arange(len(a.tids))
                want = -ll[t, tm.tid_to_pdf_array[np.asarray(
                    a.tids, np.int64)]].sum() if len(a.tids) else 0.0
                # (the archive keeps costs in float32)
                assert a.acoustic_cost == pytest.approx(want, rel=1e-6,
                                                        abs=1e-6)
