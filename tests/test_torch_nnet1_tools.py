"""The port's 19 nnet1 tools (nnet-info, nnet-copy, nnet-concat,
nnet-forward, rbm-train-cd1-frmshuff, rbm-convert-to-nnet,
nnet-train-frmshuff and cmvn-to-nnet of cli/tools_bank19.py;
nnet-initialize, transf-to-nnet, nnet-train-perutt and the MMI and MPE
sequence trainers of tools_bank25.py; nnet1-to-raw-nnet of
tools_bank26.py; the two multistream trainers, train-transitions and
nnet-set-learnrate of tools_bank29.py; align-compiled-mapped of
tools_bank28.py), each run through the port's registry (``--device=cpu``
where it computes) and the JAX package's on the same files.

The files are written once by a module fixture: the yes/no task's .mdl,
HCLG and training graphs, six utterances of about 100 frames of 13
MFCCs and their globally normalized copy, seeded log-likelihoods, the
JAX tools' alignments of them (align-mapped, ali-to-pdf), lattices
decoded from them, and nnet1 models written by the JAX tools
(nnet-initialize of 13 → 16 → 12 → 18, nnet-train-frmshuff's fine-tuned
model with its priors).  nnet-initialize draws flax's distributions from
a ``torch.Generator``: held by shapes, zero biases and the kernels'
scale.  rbm-train-cd1-frmshuff runs with JAX's CD-1 draws replayed
(``am/nnet1.py`` ``draw_uniform`` replaced, as tests/test_torch_nnet1.py
does; no draw of it lies within 1e-6 of its probability, so no hidden
sample flips), and with the upstream ``--learn-rate`` the port adds
against the JAX package's ``train_rbm`` at that rate.  The sequence
trainers equal the JAX tools on ε-free lattices; on a decoder's
lattices, which the originals refuse (ε arcs), the port is held against
the JAX library with the ε arcs removed.  Bars: host tools' files and printed lines byte-equal;
forwards within 1e-4 of the largest entry; trained parameters within
1e-4 of each tensor's largest (float32 sums in another order), a frozen
layer bit-equal; alignments equal.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am import nnet1 as tn
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import write_mdl
from kaldi_tpu_torch.cli import TOOLS
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.fst.openfst_io import write_fst_path
from test_torch_beam import PORT, yesno_graph

torch.set_num_threads(1)

CPU = ("--device=cpu",)
REL = 1e-4
OUT = {}
NUM_UTTS = 6
PROTO = ("<AffineTransform> <InputDim> 13 <OutputDim> 16\n<Sigmoid>\n"
         "<AffineTransform> <InputDim> 16 <OutputDim> 12\n<Sigmoid>\n"
         "<AffineTransform> <InputDim> 12 <OutputDim> {P}\n<Softmax>\n")


def run(name, args, port_opts=(), jax=True, tag=""):
    """Run ``name`` on the port (and the JAX package); ``{out}`` in args
    is a per-side path → (port out, jax out, port stdout, jax stdout)."""
    outs, prints = {}, {}
    sides = [("port", ttools.main, list(port_opts))]
    if jax:
        sides.append(("jax", jtools.main, []))
    for side, main, extra in sides:
        out = f"{OUT['d']}/{name}{tag}.{side}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([name, *extra, *[a.replace("{out}", out)
                                       for a in args]])
        assert rc == 0, side
        outs[side], prints[side] = out, buf.getvalue()
    return outs["port"], outs.get("jax"), prints["port"], prints.get("jax")


def dev_run(name, args, **kw):
    """``run`` of a tool that computes, the port's side on the CPU."""
    return run(name, args, port_opts=CPU, **kw)


def read(spec, holder):
    return dict(SequentialTableReader(spec, holder=holder))


def close(got, want, tol=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def raw_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def fmt(s, *args):
    return [a.replace("{d}", s["d"]) for a in args]


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def same_model(got_path, want_path, tol=REL):
    """Two ``<Nnet1>`` files: the same dims, priors and factors, the
    parameters within ``tol`` of each tensor's largest entry."""
    g = tn.load_nnet1_full(got_path)
    w = tn.load_nnet1_full(want_path)
    assert g[1:3] == w[1:3]
    for a, b in ((g[3], w[3]), (g[4], w[4])):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    lg, lw = list(leaves(g[0])), list(leaves(w[0]))
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (_, x), (_, y) in zip(lg, lw):
        close(x, y, tol)
    return g, w


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    d = tmp_path_factory.mktemp("nnet1")
    OUT["d"] = str(d)
    lang, tm, HCLG = yesno_graph(PORT, "three_state")
    P = tm.num_pdfs
    rng = np.random.default_rng(30)
    write_mdl(f"{d}/final.mdl", tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device="cpu"))
    write_fst_path(f"{d}/HCLG.fst", HCLG)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0)),
                device="cpu")
    feats = {}
    for i in range(NUM_UTTS):
        n = 16000 + 400 * i
        t = np.arange(n) / 16000.0
        x = 2000 * np.sin(2 * np.pi * (150 + 60 * i) * t) \
            + 300 * rng.standard_normal(n)
        feats[f"utt{i}"] = mfcc.compute(x.astype(np.float32)).numpy()
    allf = np.concatenate(list(feats.values())).astype(np.float64)
    stats = np.zeros((2, 14))
    stats[0, :13], stats[1, :13] = allf.sum(0), (allf ** 2).sum(0)
    stats[0, 13] = len(allf)
    with kio.open_wxfilename(f"{d}/cmvn.mat") as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, stats)
    mu, sd = allf.mean(0), allf.std(0)
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w, \
            TableWriter(f"ark:{d}/nfeats.ark", holder="mat") as wn:
        for k, v in feats.items():
            w[k] = v
            wn[k] = ((v - mu) / sd).astype(np.float32)
    with TableWriter(f"ark:{d}/ll.ark", holder="mat") as w:
        for k, v in feats.items():
            w[k] = (2.0 * rng.standard_normal((len(v), P))).astype(np.float32)
    with open(f"{d}/lexicon.txt", "w") as f:
        f.write("YES Y EH S\nNO N OW\n")
    with TableWriter(f"ark,t:{d}/text", holder="text") as w:
        for i, k in enumerate(sorted(feats)):
            w[k] = [("YES", "NO")[(i + j) % 2] for j in range(1 + i % 3)]
    assert jtools.main(["compile-train-graphs", f"{d}/lexicon.txt",
                        f"{d}/final.mdl", f"ark,t:{d}/text",
                        f"ark:{d}/graphs.ark"]) == 0
    assert jtools.main(["align-mapped", f"{d}/final.mdl",
                        f"ark:{d}/graphs.ark", f"ark:{d}/ll.ark",
                        f"ark:{d}/ali.ark"]) == 0
    assert jtools.main(["ali-to-pdf", f"{d}/final.mdl", f"ark:{d}/ali.ark",
                        f"ark:{d}/pdf.ark"]) == 0
    assert ttools.main(["latgen-faster-mapped", "--beam=10",
                        "--lattice-beam=3", "--acoustic-scale=0.5",
                        f"{d}/final.mdl", f"{d}/HCLG.fst", f"ark:{d}/ll.ark",
                        f"ark:{d}/lat.ark", "--device=cpu"]) == 0
    # ε-free two-path lattices (each path one arc of an alignment's
    # transition ids), which the original's sequence trainers accept
    from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice
    with TableWriter(f"ark:{d}/ll2.ark", holder="mat") as w:
        for k, v in feats.items():
            w[k] = (2.0 * rng.standard_normal((len(v), P))).astype(np.float32)
    assert jtools.main(["align-mapped", f"{d}/final.mdl",
                        f"ark:{d}/graphs.ark", f"ark:{d}/ll2.ark",
                        f"ark:{d}/ali2.ark"]) == 0
    a1, a2 = read(f"ark:{d}/ali.ark", "ivec"), read(f"ark:{d}/ali2.ark",
                                                     "ivec")
    # two utterances each (the JAX objectives compile one scan a length)
    with TableWriter(f"ark:{d}/latd.ark", holder="clat") as w:
        for k, clat in list(read(f"ark:{d}/lat.ark", "clat").items())[:2]:
            w[k] = clat
    with TableWriter(f"ark:{d}/lat2.ark", holder="clat") as w:
        for k in sorted(feats)[2:4]:
            clat = CompactLattice()
            s0, s1 = clat.add_state(), clat.add_state()
            clat.start = s0
            clat.arcs[s0].append(CompactArc(1, 0.5, 0.0, tuple(
                int(t) for t in a1[k]), s1))
            clat.arcs[s0].append(CompactArc(2, 0.7, 0.0, tuple(
                int(t) for t in a2[k]), s1))
            clat.finals[s1] = (0.0, 0.0, ())
            w[k] = clat
    with open(f"{d}/proto", "w") as f:
        f.write(PROTO.format(P=P))
    assert jtools.main(["nnet-initialize", "--seed=3", f"{d}/proto",
                        f"{d}/init.nnet"]) == 0
    assert jtools.main(["nnet-train-frmshuff", "--num-epochs=1",
                        "--minibatch-size=64", f"{d}/init.nnet",
                        f"ark:{d}/nfeats.ark", f"ark:{d}/pdf.ark",
                        f"{d}/ft.nnet"]) == 0
    return {"d": str(d), "tm": tm, "P": P, "feats": feats}


# ---------------------------------------------------------------------------
# the model file tools

def test_nnet_info(sysd):
    for model in ("init", "ft"):
        _, _, out, want = run("nnet-info", fmt(sysd, f"{{d}}/{model}.nnet"),
                              tag=model)
        assert out == want and out.startswith("input-dim 13\n")
        assert out.endswith(f"has-priors {model == 'ft'}\n")


def test_nnet_copy(sysd):
    p, j, _, _ = run("nnet-copy", fmt(sysd, "{d}/ft.nnet") + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j) == raw_bytes(f"{sysd['d']}/ft.nnet")


@pytest.mark.parametrize("drop", [False, True])
def test_nnet_concat(sysd, drop):
    p, j, _, _ = run("nnet-concat", [f"--drop-output={str(drop).lower()}"]
                     + fmt(sysd, "{d}/init.nnet", "{d}/ft.nnet")
                     + ["{out}"], tag=str(drop))
    assert raw_bytes(p) == raw_bytes(j)
    _, hid, _, pri = tn.load_nnet1(p)
    assert hid == ((16, 12, 16, 12) if drop else (16, 12, sysd["P"], 16, 12))
    assert pri is not None


def test_nnet_set_learnrate(sysd):
    p, j, _, _ = run("nnet-set-learnrate", ["--coefs=0:1:0.5"]
                     + fmt(sysd, "{d}/ft.nnet") + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    np.testing.assert_array_equal(tn.load_nnet1_full(p)[4], [0, 1, 0.5])
    with pytest.raises(KaldiError, match="coefs for"):
        TOOLS["nnet-set-learnrate"](["--coefs=1:1", f"{sysd['d']}/ft.nnet",
                                     f"{sysd['d']}/never.nnet"])


def test_nnet1_to_raw_nnet(sysd):
    from kaldi_tpu_torch.am.raw_nnet import forward, load_raw_nnet
    p, j, _, _ = run("nnet1-to-raw-nnet", fmt(sysd, "{d}/ft.nnet")
                     + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    params, hid, P, _ = tn.load_nnet1(f"{sysd['d']}/ft.nnet")
    x = sysd["feats"]["utt0"]
    with torch.no_grad():
        want = tn.nnet1_model(params, hid, P, "cpu")(torch.from_numpy(x))
    close(forward(load_raw_nnet(p), x, "cpu"), want, 1e-5)


def test_cmvn_and_transf_to_nnet(sysd):
    p, j, _, _ = run("cmvn-to-nnet", fmt(sysd, "{d}/cmvn.mat") + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    p2, j2, _, _ = run("transf-to-nnet", [p, "{out}"])
    assert raw_bytes(p2) == raw_bytes(j2)
    from kaldi_tpu_torch.cli.tools_bank25 import read_nnet1_transform
    ft = read_nnet1_transform(p2)
    x = sysd["feats"]["utt1"]
    norm = x @ ft[:, :13].T + ft[:, 13]
    assert abs(float(norm.mean())) < 0.5 and ft.shape == (13, 14)


def test_nnet_initialize_draws_flax_distributions(sysd, tmp_path):
    with open(f"{tmp_path}/proto", "w") as f:
        f.write("<AffineTransform> <InputDim> 40 <OutputDim> 256\n"
                "<Sigmoid>\n<AffineTransform> <InputDim> 256 <OutputDim> "
                "300\n<Softmax>\n")
    p, j, _, _ = run("nnet-initialize", ["--seed=7", f"{tmp_path}/proto",
                                         "{out}"])
    gp, wp = tn.load_nnet1_full(p), tn.load_nnet1_full(j)
    assert gp[1:] == ((256,), 300, None, None)
    assert tuple(wp[1]) == (256,) and wp[2:] == (300, None, None)
    gl, wl = list(leaves(gp[0])), list(leaves(wp[0]))
    assert [(k, v.shape) for k, v in gl] == [(k, v.shape) for k, v in wl]
    for k, v in gl:
        if k[-1] == "bias":
            assert not v.any()
        else:
            assert 0.9 < float(np.std(v)) * np.sqrt(v.shape[0]) < 1.1
    assert raw_bytes(p) != raw_bytes(j)
    with open(f"{tmp_path}/bad", "w") as f:
        f.write("<AffineTransform> <InputDim> 4 <OutputDim> 5\n"
                "<AffineTransform> <InputDim> 6 <OutputDim> 2\n")
    with pytest.raises(KaldiError, match="dim mismatch"):
        TOOLS["nnet-initialize"]([f"{tmp_path}/bad", f"{tmp_path}/x"])


# ---------------------------------------------------------------------------
# forward, RBM and training tools

@pytest.mark.parametrize("opts", [(), ("--divide-by-priors=true",),
                                  ("--feature-transform=T",)])
def test_nnet_forward(sysd, opts):
    d = sysd["d"]
    if opts and opts[0].endswith("=T"):
        assert jtools.main(["cmvn-to-nnet", f"{d}/cmvn.mat",
                            f"{d}/cmvn.tr"]) == 0
        assert jtools.main(["transf-to-nnet", f"{d}/cmvn.tr",
                            f"{d}/cmvn.nnet"]) == 0
        opts = (f"--feature-transform={d}/cmvn.nnet",)
    p, j, _, _ = dev_run("nnet-forward", list(opts) + fmt(
        sysd, "{d}/ft.nnet", "ark:{d}/feats.ark") + ["ark:{out}"],
        tag=str(len(opts) and opts[0][:8]))
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(want) == sorted(sysd["feats"])
    for k in want:
        close(got[k], want[k])


def test_nnet_forward_needs_priors_to_divide(sysd):
    with pytest.raises(KaldiError, match="no priors"):
        TOOLS["nnet-forward"](["--device=cpu", "--divide-by-priors=true",
                               f"{sysd['d']}/init.nnet",
                               f"ark:{sysd['d']}/feats.ark",
                               f"ark:{sysd['d']}/never.ark"])


class Replay:
    """JAX's CD-1 draws for the port's ``draw_uniform`` (one key a
    generator, split once a call); counts the draws within 1e-6 of the
    probabilities they meet."""

    def __init__(self):
        self.keys, self.near = {}, 0

    def __call__(self, gen, shape, device):
        k = self.keys.get(id(gen), jax.random.PRNGKey(gen.initial_seed()))
        k, sub = jax.random.split(k)
        self.keys[id(gen)] = k
        return torch.tensor(np.asarray(jax.random.uniform(sub, tuple(shape))))


def test_rbm_train_cd1_frmshuff_with_replayed_draws(sysd, monkeypatch):
    replay = Replay()
    real = tn.cd1_update

    def counted(rbm, v0, u, lr, gaussian_visible):
        p = torch.sigmoid(v0 @ rbm["W"] + rbm["hid_bias"])
        replay.near += int((torch.abs(u - p) < 1e-6).sum())
        return real(rbm, v0, u, lr, gaussian_visible)

    monkeypatch.setattr(tn, "draw_uniform", replay)
    monkeypatch.setattr(tn, "cd1_update", counted)
    p, j, _, _ = dev_run("rbm-train-cd1-frmshuff",
                         ["--hid-dim=10", "--num-epochs=3"]
                         + fmt(sysd, "ark:{d}/nfeats.ark") + ["{out}"])
    assert replay.near == 0 and len(replay.keys) == 1
    g, w = same_model(p, j, 1e-5)
    assert g[1:3] == ((10,), 1)
    assert np.abs(g[0]["hidden1"]["kernel"]).max() > 0.02
    # rbm-convert-to-nnet re-frames the RBM: the JAX tool's file bytes
    p2, j2, _, _ = run("rbm-convert-to-nnet", [j, "{out}"])
    assert raw_bytes(p2) == raw_bytes(j2)


def test_rbm_train_cd1_frmshuff_learn_rate(sysd, monkeypatch):
    """The upstream --learn-rate (the original fixes train_rbm's 0.05):
    held against the JAX package's train_rbm at that rate, draws
    replayed."""
    from kaldi_tpu.am import nnet1 as jn
    monkeypatch.setattr(tn, "draw_uniform", Replay())
    d = sysd["d"]
    p, _, _, _ = dev_run("rbm-train-cd1-frmshuff",
                         ["--hid-dim=10", "--num-epochs=2",
                          "--learn-rate=0.01", f"ark:{d}/nfeats.ark",
                          "{out}"], jax=False, tag="lr")
    frames = np.concatenate(list(read(f"ark:{d}/nfeats.ark",
                                      "mat").values()))
    want, _errs = jn.train_rbm(frames, 10, num_epochs=2, lr=0.01,
                               gaussian_visible=True)
    got = tn.load_nnet1(p)[0]["hidden1"]
    close(got["kernel"], want.W, 1e-5)
    close(got["bias"], want.hid_bias, 1e-5)


@pytest.mark.parametrize("variant", ["plain", "learnrate", "num-pdfs"])
def test_nnet_train_frmshuff(sysd, variant):
    d = sysd["d"]
    model, opts = f"{d}/init.nnet", ["--num-epochs=2",
                                     "--minibatch-size=64"]
    if variant == "learnrate":
        assert jtools.main(["nnet-set-learnrate", "--coefs=0:1:0.5",
                            model, f"{d}/lr.nnet"]) == 0
        model = f"{d}/lr.nnet"
    elif variant == "num-pdfs":
        assert jtools.main(["nnet-initialize", "--seed=4",
                            f"{d}/proto", f"{d}/init4.nnet"]) == 0
        p0, h0, _, _ = tn.load_nnet1(f"{d}/init4.nnet")
        p0["output_affine"] = {"kernel": np.zeros((12, 5), np.float32),
                               "bias": np.zeros(5, np.float32)}
        tn.save_nnet1(f"{d}/dummy.nnet", p0, h0, 5)
        model, opts = f"{d}/dummy.nnet", opts + [f"--num-pdfs={sysd['P']}"]
    p, j, _, _ = dev_run("nnet-train-frmshuff", opts + [model] + fmt(
        sysd, "ark:{d}/nfeats.ark", "ark:{d}/pdf.ark") + ["{out}"],
        tag=variant)
    g, w = same_model(p, j)
    assert g[3] is not None and g[3].min() >= 0.5
    before = tn.load_nnet1(model)[0]
    moved = not np.array_equal(g[0]["hidden1"]["kernel"],
                               before["hidden1"]["kernel"])
    assert moved == (variant != "learnrate")
    if variant == "learnrate":
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(g[0]["hidden1"][k],
                                          before["hidden1"][k])


@pytest.mark.parametrize("name,opts", [
    ("nnet-train-perutt", ["--learn-rate=0.05", "--num-epochs=2"]),
    ("nnet-train-multistream", ["--num-streams=3", "--batch-frames=20",
                                "--learning-rate=0.2"]),
    ("nnet-train-multistream-perutt", ["--num-streams=4",
                                       "--learning-rate=0.2"])])
def test_nnet1_trainers(sysd, name, opts):
    p, j, _, _ = dev_run(name, opts + fmt(sysd, "{d}/ft.nnet",
                                          "ark:{d}/nfeats.ark",
                                          "ark:{d}/pdf.ark") + ["{out}"])
    g, _ = same_model(p, j)
    before = tn.load_nnet1(f"{sysd['d']}/ft.nnet")[0]
    assert not np.array_equal(g[0]["hidden1"]["kernel"],
                              before["hidden1"]["kernel"])


SEQ = ["nnet-train-mmi-sequential", "nnet-train-mpe-sequential"]


@pytest.mark.parametrize("name", SEQ)
def test_nnet1_sequence_trainers(sysd, name):
    """On ε-free lattices the original's flow, faults and all:
    log-posteriors score the lattice and the numerator path is not added
    to it (ROADMAP)."""
    p, j, _, _ = dev_run(name, ["--learn-rate=0.01"] + fmt(
        sysd, "{d}/final.mdl", "{d}/ft.nnet", "ark:{d}/nfeats.ark",
        "ark:{d}/ali.ark", "ark:{d}/lat2.ark") + ["{out}"])
    g, _ = same_model(p, j)
    before = tn.load_nnet1(f"{sysd['d']}/ft.nnet")[0]
    assert not np.array_equal(g[0]["output_affine"]["kernel"],
                              before["output_affine"]["kernel"])


def jax_sequential(sysd, criterion, lats, lr):
    """The JAX package's library on the original's flow, with the
    lattices' ε arcs removed first (``remove_eps_arcs``): → its trained
    parameter tree."""
    import jax.numpy as jnp
    from kaldi_tpu.am import discriminative as jd
    from kaldi_tpu.am import nnet1 as jn
    from kaldi_tpu.lattice.lattice import compact_to_lattice
    d = sysd["d"]
    params, hid, P, _ = jn.load_nnet1(f"{d}/ft.nnet")
    model = jn.SigmoidDnn(tuple(hid), P)
    tid2pdf = sysd["tm"].tid_to_pdf_array
    alis = read(f"ark:{d}/ali.ark", "ivec")
    feats = read(f"ark:{d}/nfeats.ark", "mat")
    from kaldi_tpu.core.table import SequentialTableReader as JReader
    for key, clat in JReader(lats, holder="clat"):
        raw = compact_to_lattice(clat)
        dense = jd.lattice_to_dense(jd.remove_eps_arcs(raw), tid2pdf)
        num = tid2pdf[np.asarray(alis[key], np.int64)]
        x = jnp.asarray(feats[key][:dense.T])[None]

        def objf(p):
            sc = model.apply({"params": p}, x)[0]
            if criterion == "mmi":
                return -jd.mmi_objf(dense, sc, jnp.asarray(num[:dense.T]),
                                    acoustic_scale=0.1)
            acc = jnp.asarray((np.asarray(dense.pdf) == num[:dense.T, None])
                              .astype(np.float32))
            return -jd.smbr_objf(dense, sc, acc, acoustic_scale=0.1)
        g = jax.grad(objf)(params)
        params = jax.tree_util.tree_map(lambda a, b: a + b * (-lr),
                                        params, g)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("name", SEQ)
def test_nnet1_sequence_trainers_on_decoder_lattices(sysd, name):
    """Ported to intent: the original fails on a decoder lattice (its
    word-boundary arcs carry no transition id); the port removes those ε
    arcs first, held against the JAX library doing the same."""
    d = sysd["d"]
    args = ["--learn-rate=0.01", f"{d}/final.mdl", f"{d}/ft.nnet",
            f"ark:{d}/nfeats.ark", f"ark:{d}/ali.ark", f"ark:{d}/latd.ark"]
    with pytest.raises(ValueError, match="ε arc"):
        jtools.main([name, *args, f"{d}/never.nnet"])
    p, _, _, _ = dev_run(name, args + ["{out}"], jax=False, tag="dec")
    got = tn.load_nnet1(p)[0]
    want = jax_sequential(sysd, "mmi" if "mmi" in name else "mpe",
                          f"ark:{d}/latd.ark", 0.01)
    lg, lw = list(leaves(got)), list(leaves(want))
    assert [k for k, _ in lg] == [k for k, _ in lw]
    for (_, a), (_, b) in zip(lg, lw):
        close(a, b)


# ---------------------------------------------------------------------------
# transitions and the mapped aligner

def test_train_transitions(sysd, tmp_path):
    """nnetbin's spelling on a bare transition model."""
    from kaldi_tpu_torch.am.serialize import write_transition_model
    with kio.open_wxfilename(f"{tmp_path}/tm") as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, sysd["tm"])
    p, j, _, _ = run("train-transitions", [f"{tmp_path}/tm"]
                     + fmt(sysd, "ark:{d}/ali.ark") + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j) != raw_bytes(f"{tmp_path}/tm")


def test_align_compiled_mapped(sysd):
    """steps/nnet/align.sh's pair: nnet-forward --divide-by-priors, then
    align-compiled-mapped on its pseudo-log-likelihoods."""
    d = sysd["d"]
    assert ttools.main(["nnet-forward", "--device=cpu",
                        "--divide-by-priors=true", f"{d}/ft.nnet",
                        f"ark:{d}/nfeats.ark", f"ark:{d}/pll.ark"]) == 0
    for ll in ("ll", "pll"):
        p, j, _, _ = dev_run("align-compiled-mapped",
                             ["--acoustic-scale=0.3"]
                             + fmt(sysd, "{d}/final.mdl",
                                   "ark:{d}/graphs.ark",
                                   f"ark:{{d}}/{ll}.ark") + ["ark:{out}"],
                             tag=ll)
        got, want = read(f"ark:{p}", "ivec"), read(f"ark:{j}", "ivec")
        assert sorted(got) == sorted(want) == sorted(sysd["feats"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


DEVICE_TOOLS = {"nnet-forward": 3, "rbm-train-cd1-frmshuff": 2,
                "nnet-train-frmshuff": 4, "nnet-train-perutt": 4,
                "nnet-train-mmi-sequential": 6,
                "nnet-train-mpe-sequential": 6,
                "nnet-train-multistream": 4,
                "nnet-train-multistream-perutt": 4,
                "align-compiled-mapped": 4}


@pytest.mark.parametrize("name", sorted(DEVICE_TOOLS))
def test_tools_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        TOOLS[name]([f"never.read.{i}" for i in range(DEVICE_TOOLS[name])])


def test_every_tool_is_registered():
    names = {"nnet-info", "nnet-copy", "nnet-concat", "nnet-forward",
             "rbm-train-cd1-frmshuff", "rbm-convert-to-nnet",
             "nnet-train-frmshuff", "cmvn-to-nnet", "nnet-initialize",
             "transf-to-nnet", "nnet-train-perutt",
             "nnet-train-mmi-sequential", "nnet-train-mpe-sequential",
             "nnet1-to-raw-nnet", "nnet-train-multistream",
             "nnet-train-multistream-perutt", "train-transitions",
             "nnet-set-learnrate", "align-compiled-mapped"}
    assert len(names) == 19 and names <= set(TOOLS)
    assert names <= set(jtools.TOOLS)
