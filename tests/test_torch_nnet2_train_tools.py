"""The port's 15 nnet2 training tools, each run through the port's
registry with ``--device=cpu`` and held against the JAX package's tool of
the same name on the same files: the egs tools (nnet-get-egs,
nnet-shuffle-egs, nnet-copy-egs, nnet-subset-egs, nnet-relabel-egs), the
trainers (nnet-train-simple, nnet-train-parallel with ``preconditioned``
off and on, nnet-train-ensemble, nnet-combine-fast and its alias
nnet-combine, nnet-normalize-stddev, nnet-train-discriminative-simple and
-parallel) and the feature transforms (nnet-get-feature-transform and
-multi).

The module fixture writes every input with the JAX package's tools or
seeded numpy: 13-dim features of six utterances and their pdf
alignments, nnet2 models from the JAX nnet-am-init at 2 p-norm layers of
64 / 16 (one with the input that nnet-get-egs' default ±4 windows give,
so that the model splices each one-frame window into five copies of it,
as the original does on its defaults), a preconditioned copy, one with
per-layer learning rates (nnet-modify-learning-rates) and one with a
mixed-up softmax, egs from the JAX nnet-get-egs, discriminative egs over
seeded dense lattices, and ``<LDAACCS>`` files of seeded statistics.
Each JAX tool (its trainers jit) runs once per configuration and its
file is kept for the module.

Bars: the trained models' leaves within 1e-4 of the largest entry
(TF32 is off on the CPU); nnet-combine-fast's 30 Adam steps on the
weights' softmax logits within 1e-4 too, each step's update near
lr = 0.2 a logit, so that a float32 difference in the gradient only moves
the logits by its share of the update; the egs and the feature
transforms byte-equal.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am import nnet2 as tn
from kaldi_tpu_torch.am.transforms import LdaEstimate
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli.tools_bank16 import write_lda_accs
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.pipelines.egs_io import DiscEg
from torch_registry import TOOL_COUNT

torch.set_num_threads(1)

CPU = ("--device=cpu",)
REL = 1e-4
D, P = 13, 10
LENGTHS = (40, 47, 55, 62, 70, 33)
OUT = {}
JAX = {}


def run(name, args, tag="", port_opts=CPU):
    """Run ``name`` on the port and (once per configuration, cached for
    the module) on the JAX package; ``{out}`` in args is a per-side path.
    → (port out, jax out)."""
    outs = {}
    key = (name, tuple(args), tag)
    for side, main, extra in (("port", ttools.main, list(port_opts)),
                              ("jax", jtools.main, [])):
        out = f"{OUT['d']}/{name}{tag}.{side}"
        if side == "jax" and key in JAX:
            outs[side] = JAX[key]
            continue
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([name, *extra, *[a.replace("{out}", out)
                                       for a in args]])
        assert rc == 0, side
        outs[side] = out
    JAX[key] = outs["jax"]
    return outs["port"], outs["jax"]


def raw_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def same_model(got_path, want_path, tol=REL):
    """Two nnet2 files: the same config and priors, leaves within ``tol``
    of the largest entry."""
    (gp, gc, gpr), (wp, wc, wpr) = (tn.load_nnet2_full(got_path),
                                    tn.load_nnet2_full(want_path))
    assert gc == wc
    assert (gpr is None) == (wpr is None)
    lg, lw = dict(leaves(gp)), dict(leaves(wp))
    assert sorted(lg) == sorted(lw)
    for k in lw:
        np.testing.assert_allclose(
            lg[k], lw[k], rtol=0,
            atol=tol * max(1.0, float(np.abs(lw[k]).max())), err_msg=str(k))
    return gp, wp


def moved(path, start):
    """The largest change of any leaf from the model ``start``."""
    a = dict(leaves(tn.load_nnet2(path)[0]))
    b = dict(leaves(tn.load_nnet2(start)[0]))
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def dense_deg(rng, T, K=3):
    """A DiscEg over a seeded dense lattice of K states a boundary, each
    reached at every boundary: frame 0's arcs leave the start state for
    each state, every later frame has an arc of each pair of states, and
    one padded arc a frame."""
    pairs = np.array([(a, b) for a in range(K) for b in range(K)] + [(0, 0)],
                     np.int32)
    src = np.tile(pairs[:, 0], (T, 1))
    dst = np.tile(pairs[:, 1], (T, 1))
    src[0] = 0
    dst[0, :K * K] = np.arange(K * K) % K
    A = len(pairs)
    mask = np.ones((T, A), np.float32)
    mask[:, -1] = 0
    return DiscEg(feats=rng.standard_normal((T, D)).astype(np.float32),
                  num_ali=rng.integers(0, P, T).astype(np.int32),
                  src=src, dst=dst,
                  pdf=rng.integers(0, P, (T, A)).astype(np.int32),
                  w=(-rng.random((T, A))).astype(np.float32), mask=mask,
                  final=np.zeros(K, np.float32))


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nnet2_train"))
    OUT["d"] = d
    rng = np.random.default_rng(22)
    # features whose mean follows the pdf, so that training moves
    centers = rng.standard_normal((P, D)).astype(np.float32)
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as wf, \
            TableWriter(f"ark:{d}/ali.ark", holder="ivec") as wa, \
            TableWriter(f"ark:{d}/ali2.ark", holder="ivec") as wb:
        for i, T in enumerate(LENGTHS):
            ali = np.repeat(rng.integers(0, P, T // 5 + 1), 5)[:T]
            wf[f"utt{i}"] = (centers[ali] + 0.5 * rng.standard_normal(
                (T, D))).astype(np.float32)
            # utt5 has no alignment: skipped by the tools
            if i < 5:
                wa[f"utt{i}"] = ali.astype(np.int32)
            relab = ali.copy()
            relab[rng.random(T) < 0.3] = rng.integers(0, P)
            wb[f"utt{i}"] = relab.astype(np.int32)
    init = ["--num-hidden-layers=2", "--pnorm-input-dim=64",
            "--pnorm-output-dim=16", f"--num-pdfs={P}"]
    for srand, name, fd in ((1, "init", D), (2, "init2", D),
                            (3, "wide", 9 * D), (4, "wide2", 9 * D)):
        assert jtools.main(["nnet-am-init", f"--feat-dim={fd}", *init,
                            f"--srand={srand}", f"{d}/{name}.mdl"]) == 0
    assert jtools.main(["nnet-am-switch-preconditioning", f"{d}/init.mdl",
                        f"{d}/pc.mdl"]) == 0
    assert jtools.main(["nnet-modify-learning-rates",
                        "--average-learning-rate=0.05",
                        "--last-layer-factor=0.5", f"{d}/init.mdl",
                        f"{d}/init2.mdl", f"{d}/lr.mdl"]) == 0
    assert jtools.main(["nnet-am-mixup", f"--num-mixtures={P + 6}",
                        "--srand=5", f"{d}/init.mdl", f"{d}/mix.mdl"]) == 0
    # egs: ±2 windows the models take as they are (65 = 13 · 5), and the
    # defaults' ±4 windows (117) that "wide" splices into five copies
    assert jtools.main(["nnet-get-egs", "--left-context=2",
                        "--right-context=2", "--batch-size=16",
                        "--provenance-keys=true", f"ark:{d}/feats.ark",
                        f"ark:{d}/ali.ark", f"ark:{d}/egs.ark"]) == 0
    # 34 batches of 8 and one of 2 for nnet-train-parallel, whose
    # workers' shards the original stacks: equal at 1 and 3 threads
    assert jtools.main(["nnet-get-egs", "--left-context=2",
                        "--right-context=2", "--batch-size=8",
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        f"ark:{d}/egs_flat.ark"]) == 0
    assert jtools.main(["nnet-get-egs", "--batch-size=32",
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        f"ark:{d}/egs_wide.ark"]) == 0
    with TableWriter(f"ark:{d}/degs.ark", holder="deg") as w:
        for i in range(4):       # one shape: one jit of the original's
            w[f"deg{i}"] = dense_deg(rng, 10)
    for i in range(2):
        lda = LdaEstimate(P, 3 * D)
        x = rng.standard_normal((400, 3 * D)) * (1 + np.arange(3 * D))
        c = rng.integers(0, P, 400)
        x[:, :D] += 2 * centers[c]
        lda.accumulate_batch(x, c)
        write_lda_accs(f"{d}/lda{i}.acc", lda)
    return d


def fmt(d, *args):
    return [a.replace("{d}", d) for a in args]


# ---------------------------------------------------------------------------
# egs

@pytest.mark.parametrize("opts", [
    (), ("--left-context=2", "--right-context=2", "--batch-size=16"),
    ("--left-context=0", "--right-context=3", "--batch-size=7",
     "--provenance-keys=true"),
    ("--batch-size=500", "--provenance-keys=true")])
def test_nnet_get_egs(sysd, opts):
    p, j = run("nnet-get-egs", [*opts, *fmt(sysd, "ark:{d}/feats.ark",
                                             "ark:{d}/ali.ark"), "ark:{out}"],
               tag=str(len(opts)) + "".join(o[2] for o in opts),
               port_opts=())
    assert raw_bytes(p) == raw_bytes(j)
    egs = dict(SequentialTableReader(f"ark:{p}", holder="xeg"))
    L = dict(o[2:].split("=") for o in opts).get
    width = D * (int(L("left-context", 4)) + int(L("right-context", 4)) + 1)
    assert all(e.feats.shape[1:] == (1, width) for e in egs.values())
    assert sum(len(e.pdfs) for e in egs.values()) == sum(LENGTHS[:5])


@pytest.mark.parametrize("srand", [0, 3])
def test_nnet_shuffle_egs(sysd, srand):
    p, j = run("nnet-shuffle-egs", [f"--srand={srand}",
                                    f"ark:{sysd}/egs.ark", "ark:{out}"],
               tag=str(srand), port_opts=())
    assert raw_bytes(p) == raw_bytes(j)


@pytest.mark.parametrize("srand,n_out", [(-1, 2), (-1, 3), (4, 3)])
def test_nnet_copy_egs(sysd, srand, n_out):
    outs = {}
    for side, main in (("port", ttools.main), ("jax", jtools.main)):
        outs[side] = [f"{sysd}/copy{srand}_{n_out}.{i}.{side}"
                      for i in range(n_out)]
        assert main(["nnet-copy-egs", f"--srand={srand}",
                     f"ark:{sysd}/egs.ark",
                     *[f"ark:{o}" for o in outs[side]]]) == 0
    for a, b in zip(outs["port"], outs["jax"]):
        assert raw_bytes(a) == raw_bytes(b)
    n = sum(len(list(SequentialTableReader(f"ark:{o}", holder="xeg")))
            for o in outs["port"])
    assert n == len(list(SequentialTableReader(f"ark:{sysd}/egs.ark",
                                               holder="xeg")))


@pytest.mark.parametrize("opts", [("--n=5",), ("--n=5", "--srand=9"),
                                  ("--n=4", "--randomize-order=false"),
                                  ("--n=1000",)])
def test_nnet_subset_egs(sysd, opts):
    p, j = run("nnet-subset-egs", [*opts, f"ark:{sysd}/egs.ark",
                                   "ark:{out}"],
               tag="".join(o[2:5] for o in opts), port_opts=())
    assert raw_bytes(p) == raw_bytes(j)


def test_nnet_relabel_egs(sysd):
    p, j = run("nnet-relabel-egs", fmt(sysd, "ark:{d}/ali2.ark",
                                       "ark:{d}/egs.ark") + ["ark:{out}"],
               port_opts=())
    assert raw_bytes(p) == raw_bytes(j)
    assert raw_bytes(p) != raw_bytes(f"{sysd}/egs.ark")


def test_nnet_relabel_egs_needs_provenance_keys(sysd):
    for tools in (ttools.TOOLS, jtools.TOOLS):
        with pytest.raises(Exception, match="no provenance"):
            tools["nnet-relabel-egs"](fmt(sysd, "ark:{d}/ali2.ark",
                                          "ark:{d}/egs_wide.ark",
                                          "ark:{d}/never.ark"))


# ---------------------------------------------------------------------------
# trainers

@pytest.mark.parametrize("model", ["init", "lr", "mix", "pc"])
def test_nnet_train_simple(sysd, model):
    p, j = run("nnet-train-simple",
               ["--learning-rate=0.05", "--chunk-size=16",
                *fmt(sysd, f"{{d}}/{model}.mdl", "ark:{d}/feats.ark",
                     "ark:{d}/ali.ark"), "{out}"], tag=model)
    same_model(p, j)
    assert moved(p, f"{sysd}/{model}.mdl") > 1e-3


@pytest.mark.parametrize("preconditioned", [False, True])
@pytest.mark.parametrize("threads", [1, 3])
def test_nnet_train_parallel(sysd, preconditioned, threads):
    """NG-SGD's first step is the raw gradient's, as the original's
    ``scale_ng``; both settings hold."""
    model = "pc" if preconditioned else "init"
    p, j = run("nnet-train-parallel",
               [f"--num-threads={threads}", "--learning-rate=0.5",
                *fmt(sysd, f"{{d}}/{model}.mdl", "ark:{d}/egs_flat.ark"),
                "{out}"], tag=f"{model}{threads}")
    same_model(p, j)
    assert tn.load_nnet2(p)[1].preconditioned == preconditioned
    assert moved(p, f"{sysd}/{model}.mdl") > 1e-3


def test_nnet_train_parallel_on_the_default_windows(sysd):
    """nnet-get-egs' defaults (±4) into a model of 9 · 13 inputs: the
    model splices each one-frame window into five copies of it, in the
    port as in the original."""
    p, j = run("nnet-train-parallel",
               ["--num-threads=2", "--learning-rate=0.5",
                *fmt(sysd, "{d}/wide.mdl", "ark:{d}/egs_wide.ark"),
                "{out}"], tag="wide")
    same_model(p, j)
    assert tn.load_nnet2(p)[0]["pnorm1"]["affine"]["kernel"].shape == \
        (9 * D * 5, 64)


def test_preconditioned_first_step_is_the_sgd_step(sysd):
    """One step of NG-SGD from a fresh state equals one step of SGD."""
    p, _ = run("nnet-train-parallel",
               ["--num-threads=3", "--learning-rate=0.5",
                *fmt(sysd, "{d}/pc.mdl", "ark:{d}/egs_flat.ark"), "{out}"],
               tag="pc3")
    q, _ = run("nnet-train-parallel",
               ["--num-threads=3", "--learning-rate=0.5",
                *fmt(sysd, "{d}/init.mdl", "ark:{d}/egs_flat.ark"),
                "{out}"], tag="init3")
    a, b = dict(leaves(tn.load_nnet2(p)[0])), dict(leaves(tn.load_nnet2(q)[0]))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_nnet_train_ensemble(sysd, beta):
    outs = {}
    for side, main, extra in (("port", ttools.main, list(CPU)),
                              ("jax", jtools.main, [])):
        outs[side] = [f"{sysd}/ens{beta}.{i}.{side}" for i in range(2)]
        assert main(["nnet-train-ensemble", *extra, f"--beta={beta}",
                     "--learning-rate=0.3", f"ark:{sysd}/egs_flat.ark",
                     f"{sysd}/init.mdl", f"{sysd}/init2.mdl",
                     *outs[side]]) == 0
    for a, b in zip(outs["port"], outs["jax"]):
        same_model(a, b)
    assert moved(outs["port"][0], f"{sysd}/init.mdl") > 1e-3


def test_ensemble_target_carries_no_gradient(sysd):
    """β = 1 against a copy of the model itself: the target is the
    model's own posterior as a constant, so the step is the gradient of
    −Σ p̄·log p at p̄ = p, which is zero; a target that carried gradient
    would step by ∇ of the entropy."""
    egs = [e for _k, e in SequentialTableReader(f"ark:{sysd}/egs_flat.ark",
                                                holder="xeg")][:2]
    params, cfg = tn.load_nnet2(f"{sysd}/init.mdl")
    out, _loss, _n = tn.train_ensemble([params, params], cfg, egs, 1.0,
                                       0.5, device="cpu")
    for (_k, a), (_k2, b) in zip(leaves(out[0]), leaves(params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["nnet-combine-fast", "nnet-combine"])
@pytest.mark.parametrize("models", [("init", "init2"),
                                    ("init", "init2", "lr")])
def test_nnet_combine(sysd, name, models):
    p, j = run(name, [*fmt(sysd, "ark:{d}/feats.ark", "ark:{d}/ali.ark"),
                      *[f"{sysd}/{m}.mdl" for m in models], "{out}"],
               tag=str(len(models)))
    same_model(p, j)


@pytest.mark.parametrize("model,stddev", [("init", 1.0), ("mix", 0.5),
                                          ("lr", 2.0)])
def test_nnet_normalize_stddev(sysd, model, stddev):
    p, j = run("nnet-normalize-stddev",
               [f"--stddev={stddev}",
                *fmt(sysd, f"{{d}}/{model}.mdl", "ark:{d}/egs.ark"),
                "{out}"], tag=f"{model}{stddev}")
    got, _ = same_model(p, j)
    # the first layer's output has the asked-for stddev on the egs
    x = np.concatenate([e.feats for _k, e in SequentialTableReader(
        f"ark:{sysd}/egs.ark", holder="xeg")])
    k1 = got["pnorm1"]["affine"]
    assert float((x @ k1["kernel"] + k1["bias"]).std()) == \
        pytest.approx(stddev, rel=1e-4)


@pytest.mark.parametrize("criterion", ["smbr", "mmi"])
def test_nnet_train_discriminative_simple(sysd, criterion):
    p, j = run("nnet-train-discriminative-simple",
               [f"--criterion={criterion}", "--learning-rate=0.001",
                *fmt(sysd, "{d}/init.mdl", "ark:{d}/degs.ark"), "{out}"],
               tag=criterion)
    same_model(p, j)
    assert moved(p, f"{sysd}/init.mdl") > 1e-4


@pytest.mark.parametrize("criterion,threads", [("mmi", 2), ("smbr", 3)])
def test_nnet_train_discriminative_parallel(sysd, criterion, threads):
    p, j = run("nnet-train-discriminative-parallel",
               [f"--criterion={criterion}", f"--num-threads={threads}",
                "--learning-rate=0.001",
                *fmt(sysd, "{d}/init.mdl", "ark:{d}/degs.ark"), "{out}"],
               tag=criterion)
    same_model(p, j)


@pytest.mark.parametrize("criterion", ["smbr", "mmi"])
def test_phase_23_adam_card_cpu_measure_fails_a_wrong_step(sysd, criterion):
    """chip_smoke 23i's card = CPU measure of one Adam step: 0 for the
    same step, about 1 for no step and 2 for the step reversed (its bar
    is 1e-2); its gradient is the one the trainer steps against."""
    import chip_smoke as cs
    p0, cfg = tn.load_nnet2(f"{sysd}/init.mdl")
    deg = next(iter(SequentialTableReader(f"ark:{sysd}/degs.ark",
                                          holder="deg")))[1]
    p1, _loss = tn.train_discriminative(p0, cfg, [deg], criterion, 5e-5,
                                        0.1, 1, "cpu")
    _f, g = cs._disc_grad(p0, cfg, deg, criterion, torch.device("cpu"))
    back = tn.tree_map(lambda a, b: 2 * a - b, p0, p1)
    same, share, _rest = cs._adam_step_rel(p1, p1, p0, g)
    none = cs._adam_step_rel(p0, p1, p0, g)[0]
    rev = cs._adam_step_rel(back, p1, p0, g)[0]
    assert same == 0 and 0 < share <= 1
    assert none == pytest.approx(1.0, rel=1e-2)
    assert none > cs.N2T_ADAM_STEP_TOL
    assert rev == pytest.approx(2.0, rel=1e-2)
    for (_k, a), (_k2, b), (_k3, gr) in zip(*map(leaves, (p0, p1, g))):
        keep = np.abs(gr) >= cs.N2T_NOISE * np.abs(gr).max()
        assert np.array_equal(np.sign(a - b)[keep], np.sign(gr)[keep])


def test_discriminative_trainers_refuse_an_unknown_criterion(sysd):
    for name in ("nnet-train-discriminative-simple",
                 "nnet-train-discriminative-parallel"):
        for tools, extra in ((ttools.TOOLS, list(CPU)), (jtools.TOOLS, [])):
            with pytest.raises(Exception, match="unknown criterion"):
                tools[name]([*extra, "--criterion=mpe",
                             *fmt(sysd, "{d}/init.mdl", "ark:{d}/degs.ark",
                                  "{d}/never.mdl")])


# ---------------------------------------------------------------------------
# feature transforms

@pytest.mark.parametrize("opts,accs", [
    ((), ("lda0",)), (("--within-class-factor=0.1",), ("lda0", "lda1")),
    (("--dim=20", "--within-class-factor=1.0"), ("lda1",))])
def test_nnet_get_feature_transform(sysd, opts, accs):
    p, j = run("nnet-get-feature-transform",
               [*opts, "{out}", *[f"{sysd}/{a}.acc" for a in accs]],
               tag="".join(accs) + str(len(opts)), port_opts=())
    assert raw_bytes(p) == raw_bytes(j)


@pytest.mark.parametrize("groups", ["0:1:2", "0,1:2", "0,1,2", "2:0"])
def test_nnet_get_feature_transform_multi(sysd, groups):
    p, j = run("nnet-get-feature-transform-multi",
               [f"--context-groups={groups}", f"--feat-dim={D}",
                f"{sysd}/lda0.acc", "{out}"], tag=groups.replace(":", "_"),
               port_opts=())
    assert raw_bytes(p) == raw_bytes(j)


def test_feature_transform_multi_is_block_diagonal(sysd):
    """One group a context position: the block transform's rows for
    position c read only that position's columns (and the offset)."""
    from kaldi_tpu_torch.core import io as kio
    p, _ = run("nnet-get-feature-transform-multi",
               ["--context-groups=0:1:2", f"--feat-dim={D}",
                f"{sysd}/lda0.acc", "{out}"], tag="0_1_2", port_opts=())
    with kio.open_rxfilename(p) as f:
        kio.init_kaldi_input_stream(f)
        m = np.asarray(kio.read_matrix(f))
    assert m.shape == (3 * D, 3 * D + 1)
    for c in range(3):
        rows = m[c * D:(c + 1) * D, :-1]
        off = np.delete(rows, np.s_[c * D:(c + 1) * D], axis=1)
        assert np.all(off == 0) and np.abs(rows[:, c * D:(c + 1) * D]).max() > 0


def test_feature_transform_multi_needs_its_options(sysd):
    for tools in (ttools.TOOLS, jtools.TOOLS):
        with pytest.raises(Exception, match="required"):
            tools["nnet-get-feature-transform-multi"](
                [f"{sysd}/lda0.acc", f"{sysd}/never.mat"])


# ---------------------------------------------------------------------------
# the registry

def test_every_tool_is_registered():
    names = {"nnet-get-egs", "nnet-shuffle-egs", "nnet-copy-egs",
             "nnet-subset-egs", "nnet-relabel-egs", "nnet-train-simple",
             "nnet-train-parallel", "nnet-train-ensemble",
             "nnet-combine-fast", "nnet-combine", "nnet-normalize-stddev",
             "nnet-train-discriminative-simple",
             "nnet-train-discriminative-parallel",
             "nnet-get-feature-transform",
             "nnet-get-feature-transform-multi"}
    assert len(names) == 15
    assert names <= set(ttools.TOOLS) and names <= set(jtools.TOOLS)
    assert len(ttools.TOOLS) == TOOL_COUNT
