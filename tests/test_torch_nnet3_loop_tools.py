"""The 24 tools of the port's nnet3 cross-entropy loop and its base tools
(ali-to-pdf, gmm-info, lattice-to-nbest in cli/tools.py; feat-to-dim,
feat-to-len, nnet3-info, nnet3-copy in cli/tools_extra.py; the egs,
compute-prob and alignment tools of cli/tools_bank14.py; nnet3-combine,
nnet3-subset-egs, nnet3-acc-lda-stats and align-mapped of
tools_bank16.py; nnet3-chain-acc-lda-stats, nnet3-am-init and
nnet3-am-train-transitions of tools_bank23.py; nnet3-compute-from-egs of
tools_bank18.py; nnet3-get-egs-simple, nnet3-am-info and analyze-counts
of tools_bank29.py, 10 and 12), each run through the port's registry
(``--device=cpu`` where it computes) and the JAX package's on the same
files.

The files are written once by a module fixture: the yes/no task's .mdl,
HCLG and training graphs, three utterances of 54, 60 and 75 frames of 13
MFCCs, seeded log-likelihoods, the JAX tools' alignments of them
(align-mapped) and pdf alignments (ali-to-pdf), two raw TDNN-Fs written
by the JAX package's nnet3-init (2 layers of 32 / 8), lattices decoded
from the log-likelihoods, and chain egs.  Bars: host tools' files and
printed lines equal byte for byte; matrices within 1e-4 of the largest
entry (float32 sums in another order); alignments equal;
nnet3-compute-prob's printed figures within 1.5e-4 (four decimals);
nnet3-acc-lda-stats' float64 sums within 1e-9 of each matrix's largest
(it sums all frames in one product, the original frame by frame);
nnet3-combine's weights (recovered from its output model) within 1e-4
and its parameters within 1e-4 of each tensor's largest, at 4 Adam
steps.  nnet3-compute-from-egs is ported to intent: on merged egs of
B > 1 sequences it writes all B·T rows, held row for row against the
same tool on the B single-sequence egs (for B = 1 it equals the JAX
tool).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import write_mdl
from kaldi_tpu_torch.cli import TOOLS
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.fst.openfst_io import write_fst_path
from kaldi_tpu_torch.pipelines.egs_io import ChainEg
from test_torch_beam import PORT, yesno_graph

torch.set_num_threads(1)

CPU = ("--device=cpu",)
REL = 1e-4
OUT = {}
LENGTHS = (9000, 9840, 12340)
TDNN = ("--feat-dim=13", "--hidden-dim=32", "--bottleneck-dim=8",
        "--num-layers=2")


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


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    d = tmp_path_factory.mktemp("nnet3loop")
    OUT["d"] = str(d)
    lang, tm, HCLG = yesno_graph(PORT, "three_state")
    P = tm.num_pdfs
    rng = np.random.default_rng(21)
    write_mdl(f"{d}/final.mdl", tm,
              AmDiagGmm(np.full((P, 2), 0.5), rng.standard_normal((P, 2, 13)),
                        np.ones((P, 2, 13)), device="cpu"))
    write_fst_path(f"{d}/HCLG.fst", HCLG)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0)),
                device="cpu")
    feats = {}
    for i, n in enumerate(LENGTHS):
        t = np.arange(n) / 16000.0
        x = 2000 * np.sin(2 * np.pi * (150 + 80 * i) * t) \
            + 300 * rng.standard_normal(n)
        feats[f"utt{i}"] = mfcc.compute(x.astype(np.float32)).numpy()
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        for k, v in feats.items():
            w[k] = v
    with TableWriter(f"ark:{d}/ll.ark", holder="mat") as w:
        for k, v in feats.items():
            w[k] = (2.0 * rng.standard_normal((len(v), P))).astype(np.float32)
    with open(f"{d}/lexicon.txt", "w") as f:
        f.write("YES Y EH S\nNO N OW\n")
    with TableWriter(f"ark,t:{d}/text", holder="text") as w:
        for k, words in zip(sorted(feats), (["YES", "NO"], ["NO"],
                                            ["YES", "YES", "NO"])):
            w[k] = words
    assert jtools.main(["compile-train-graphs", f"{d}/lexicon.txt",
                        f"{d}/final.mdl", f"ark,t:{d}/text",
                        f"ark:{d}/graphs.ark"]) == 0
    assert jtools.main(["align-mapped", f"{d}/final.mdl",
                        f"ark:{d}/graphs.ark", f"ark:{d}/ll.ark",
                        f"ark:{d}/ali.ark"]) == 0
    assert jtools.main(["ali-to-pdf", f"{d}/final.mdl", f"ark:{d}/ali.ark",
                        f"ark:{d}/pdf.ark"]) == 0
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    gen = torch.Generator().manual_seed(21)
    for srand in (1, 2):
        path = f"{d}/m{srand}.raw"
        assert jtools.main(["nnet3-init", *TDNN, f"--num-pdfs={P}",
                            f"--srand={srand}", path]) == 0
        # flax's init leaves the output layer zero: seeded weights there,
        # so that the models' outputs differ
        net, cfg = _read_raw_auto(path, "cpu")
        with torch.no_grad():
            net.output_affine.weight.normal_(0.0, 0.5, generator=gen)
        write_raw_model(path, net.state_dict(), cfg)
    assert ttools.main(["latgen-faster-mapped", "--beam=12",
                        "--lattice-beam=5", f"{d}/final.mdl",
                        f"{d}/HCLG.fst", f"ark:{d}/ll.ark",
                        f"ark:{d}/lat.ark", "--device=cpu"]) == 0
    pdf = read(f"ark:{d}/pdf.ark", "ivec")
    with TableWriter(f"ark:{d}/cegs.ark", holder="ceg") as w:
        for k, x in feats.items():
            n = len(x) // 3
            w[k] = ChainEg(feats=x[:3 * n], pdf_ali=pdf[k][:3 * n:3],
                           mask=(np.arange(n) % 5 != 4))
    # egs of 16 frames (every utterance's chunks and tail), and merged
    # egs of 2 such sequences
    assert jtools.main(["nnet3-get-egs", "--chunk-size=16",
                        f"ark:{d}/feats.ark", f"ark:{d}/pdf.ark",
                        f"ark:{d}/egs.ark"]) == 0
    assert jtools.main(["nnet3-merge-egs", "--minibatch-size=2",
                        f"ark:{d}/egs.ark", f"ark:{d}/megs.ark"]) == 0
    return {"d": str(d), "tm": tm, "P": P, "feats": feats, "pdf": pdf}


# ---------------------------------------------------------------------------
# base tools

def test_ali_to_pdf(sysd):
    p, j, _, _ = run("ali-to-pdf", fmt(sysd, "{d}/final.mdl",
                                       "ark:{d}/ali.ark") + ["ark:{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    ali = read(f"ark:{sysd['d']}/ali.ark", "ivec")
    got = read(f"ark:{p}", "ivec")
    for k, a in ali.items():
        np.testing.assert_array_equal(
            got[k], sysd["tm"].tid_to_pdf_array[np.asarray(a)])


def test_gmm_info(sysd):
    _, _, out, want = run("gmm-info", fmt(sysd, "{d}/final.mdl"))
    assert out == want and f"number of pdfs {sysd['P']}" in out
    assert "number of gaussians" in out


def test_lattice_to_nbest(sysd):
    p, j, _, _ = run("lattice-to-nbest", ["--n=3"]
                     + fmt(sysd, "ark:{d}/lat.ark") + ["ark:{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    keys = list(read(f"ark:{p}", "clat"))
    assert "utt0-1" in keys and len(keys) > 3


def test_feat_to_dim_and_len(sysd):
    _, _, out, want = run("feat-to-dim", fmt(sysd, "ark:{d}/feats.ark"))
    assert out == want == "13\n"
    _, _, out, want = run("feat-to-len", fmt(sysd, "ark:{d}/feats.ark"))
    assert out == want and out.split()[1] == str(len(sysd["feats"]["utt0"]))
    p, j, _, _ = run("feat-to-len", fmt(sysd, "ark:{d}/feats.ark")
                     + ["ark,t:{out}"], tag="w")
    assert raw_bytes(p) == raw_bytes(j)


def test_nnet3_info_and_copy(sysd):
    """nnet3-info is ported to intent: the original calls the property
    ``FieldValue.as_int`` and fails on every file; the port prints each
    component's dims, held against the file's components."""
    from kaldi_tpu_torch.am.nnet3_io import read_nnet3_path
    with pytest.raises(TypeError):
        jtools.main(["nnet3-info", f"{sysd['d']}/m1.raw"])
    out, _, lines, _ = run("nnet3-info", fmt(sysd, "{d}/m1.raw"), jax=False)
    comps = read_nnet3_path(f"{sysd['d']}/m1.raw").components
    lines = lines.splitlines()
    assert lines[0] == f"num-components {len(comps)}"
    assert len(lines) == len(comps) + 1
    for c, ln in zip(comps, lines[1:]):
        dims = " ".join(f"{k.lower()}={c.fields[k].as_int}"
                        for k in ("InputDim", "OutputDim", "Dim")
                        if k in c.fields)
        assert ln == f"component name={c.name} type={c.ctype} {dims}"
    assert any("dim=32" in ln for ln in lines)
    p, j, _, _ = run("nnet3-copy", fmt(sysd, "{d}/m1.raw") + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j) == raw_bytes(f"{sysd['d']}/m1.raw")


# ---------------------------------------------------------------------------
# egs

def test_nnet3_get_egs(sysd):
    p, j, _, _ = run("nnet3-get-egs", ["--chunk-size=16"]
                     + fmt(sysd, "ark:{d}/feats.ark", "ark:{d}/pdf.ark")
                     + ["ark:{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    egs = read(f"ark:{p}", "xeg")
    assert "utt0-0" in egs and egs["utt0-0"].feats.shape == (1, 16, 13)


def test_nnet3_get_egs_refuses_a_length_mismatch(sysd, tmp_path):
    with TableWriter(f"ark:{tmp_path}/short.ark", holder="ivec") as w:
        w["utt0"] = sysd["pdf"]["utt0"][:-1]
    with pytest.raises(KaldiError, match="length mismatch"):
        TOOLS["nnet3-get-egs"]([f"ark:{sysd['d']}/feats.ark",
                                f"ark:{tmp_path}/short.ark",
                                f"ark:{tmp_path}/x.ark"])


@pytest.mark.parametrize("name,opts", [
    ("nnet3-copy-egs", ["--n=3"]), ("nnet3-shuffle-egs", ["--srand=5"]),
    ("nnet3-merge-egs", ["--minibatch-size=3"]),
    ("nnet3-subset-egs", ["--n=4", "--srand=2"])])
def test_egs_host_tools(sysd, name, opts):
    p, j, _, _ = run(name, opts + fmt(sysd, "ark:{d}/egs.ark")
                     + ["ark:{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    assert len(read(f"ark:{p}", "xeg")) > 0


def test_nnet3_get_egs_simple(sysd):
    p, j, _, _ = run("nnet3-get-egs-simple",
                     fmt(sysd, "ark:{d}/feats.ark", "ark:{d}/pdf.ark")
                     + ["ark:{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    egs = read(f"ark:{p}", "xeg")
    assert egs["utt2"].feats.shape == (1,) + sysd["feats"]["utt2"].shape


# ---------------------------------------------------------------------------
# the network tools

def _numbers(line):
    w = line.split()
    return float(w[3]), float(w[5]), int(w[7])


@pytest.mark.parametrize("egs", ["egs", "megs"])
def test_nnet3_compute_prob(sysd, egs):
    _, _, out, want = dev_run("nnet3-compute-prob",
                          fmt(sysd, "{d}/m1.raw", f"ark:{{d}}/{egs}.ark"),
                          tag=egs)
    (lp, acc, n), (wlp, wacc, wn) = _numbers(out), _numbers(want)
    assert n == wn and abs(lp - wlp) <= 1.5e-4 and abs(acc - wacc) <= 1.5e-4
    assert out.startswith("log-probability per frame")


def test_nnet3_compute_from_egs_single_sequences(sysd):
    p, j, _, _ = dev_run("nnet3-compute-from-egs",
                     fmt(sysd, "{d}/m1.raw", "ark:{d}/egs.ark")
                     + ["ark:{out}"])
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])
    p, j, _, _ = dev_run("nnet3-compute-from-egs", ["--apply-exp=true"]
                     + fmt(sysd, "{d}/m1.raw", "ark:{d}/egs.ark")
                     + ["ark:{out}"], tag="exp")
    for k, v in read(f"ark:{p}", "mat").items():
        close(v, read(f"ark:{j}", "mat")[k])
        np.testing.assert_allclose(v.sum(1), 1.0, atol=1e-5)


def test_nnet3_compute_from_egs_writes_every_sequence(sysd):
    """Ported to intent: a merged eg of B sequences gives B·T rows, each
    sequence's rows those of the tool on that sequence alone; its first
    T rows are the JAX tool's whole output."""
    d = sysd["d"]
    p, j, _, _ = dev_run("nnet3-compute-from-egs",
                     fmt(sysd, "{d}/m1.raw", "ark:{d}/megs.ark")
                     + ["ark:{out}"], tag="merged")
    single, _, _, _ = dev_run("nnet3-compute-from-egs",
                          fmt(sysd, "{d}/m1.raw", "ark:{d}/egs.ark")
                          + ["ark:{out}"], jax=False, tag="single")
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    one = read(f"ark:{single}", "mat")
    singles = [k for k, _ in SequentialTableReader(f"ark:{d}/egs.ark",
                                                   holder="xeg")]
    merged = read(f"ark:{d}/megs.ark", "xeg")
    i = 0
    for k in sorted(merged, key=lambda s: int(s.split("-")[1])):
        B, T = merged[k].pdfs.shape
        assert got[k].shape == (B * T, sysd["P"])
        close(got[k][:T], want[k])
        for b in range(B):
            close(got[k][b * T:(b + 1) * T], one[singles[i]], 1e-5)
            i += 1
    assert i == len(singles) and any(e.pdfs.shape[0] > 1
                                     for e in merged.values())


def test_nnet3_align_compiled(sysd):
    p, j, _, _ = dev_run("nnet3-align-compiled", ["--acoustic-scale=0.5"]
                     + fmt(sysd, "{d}/final.mdl", "{d}/m1.raw",
                           "ark:{d}/graphs.ark", "ark:{d}/feats.ark")
                     + ["ark:{out}"])
    got, want = read(f"ark:{p}", "ivec"), read(f"ark:{j}", "ivec")
    assert sorted(got) == sorted(want) == sorted(sysd["feats"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert len(got[k]) == len(sysd["feats"][k])


def test_align_mapped(sysd):
    p, j, _, _ = dev_run("align-mapped", ["--acoustic-scale=0.3"]
                     + fmt(sysd, "{d}/final.mdl", "ark:{d}/graphs.ark",
                           "ark:{d}/ll.ark") + ["ark:{out}"])
    got, want = read(f"ark:{p}", "ivec"), read(f"ark:{j}", "ivec")
    assert sorted(got) == sorted(want) == sorted(sysd["feats"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _weights(path, models):
    """The combination weights of ``path``'s parameters over ``models``'
    (least squares on every parameter, as one vector)."""
    def flat(p):
        net, _ = _read_raw_auto(p, "cpu")
        return torch.cat([v.detach().reshape(-1) for v in net.parameters()]
                         ).double().numpy()
    A = np.stack([flat(m) for m in models], 1)
    return np.linalg.lstsq(A, flat(path), rcond=None)[0]


def test_nnet3_combine(sysd):
    d = sysd["d"]
    p, j, _, _ = dev_run("nnet3-combine", ["--num-iters=4"]
                     + fmt(sysd, "ark:{d}/feats.ark", "ark:{d}/pdf.ark",
                           "{d}/m1.raw", "{d}/m2.raw") + ["{out}"])
    models = [f"{d}/m1.raw", f"{d}/m2.raw"]
    gw, ww = _weights(p, models), _weights(j, models)
    np.testing.assert_allclose(gw, ww, atol=1e-4)
    assert abs(gw.sum() - 1.0) < 1e-5 and abs(gw[0] - 0.5) > 1e-3
    got = _read_raw_auto(p, "cpu")[0].state_dict()
    want = _read_raw_auto(j, "cpu")[0].state_dict()
    for k in want:
        close(got[k], want[k])


def test_nnet3_combine_of_one_model_is_it(sysd):
    """The port writes its input's bytes back.  The JAX tool's file
    differs in one header field only: the original's
    ``infer_tdnn_config`` takes the input affine's spliced width for the
    feature dim, so its writer declares the input node 3 × 13 wide."""
    p, j, _, _ = dev_run("nnet3-combine", fmt(sysd, "ark:{d}/feats.ark",
                                              "ark:{d}/pdf.ark", "{d}/m1.raw")
                         + ["{out}"], tag="one")
    assert raw_bytes(p) == raw_bytes(f"{sysd['d']}/m1.raw")
    assert raw_bytes(j) == raw_bytes(p).replace(
        b"input-node name=input dim=13", b"input-node name=input dim=39", 1)


# ---------------------------------------------------------------------------
# LDA stats, the am tools and the counts

def _lda_accs(path):
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<LDAACCS>")
        return [np.asarray(kio.read_matrix(f), np.float64)
                for _ in range(3)]


def test_nnet3_acc_lda_stats(sysd):
    p, j, _, _ = run("nnet3-acc-lda-stats",
                     fmt(sysd, "ark:{d}/egs.ark") + ["{out}"])
    for g, w in zip(_lda_accs(p), _lda_accs(j)):
        close(g, w, 1e-9)
    assert _lda_accs(p)[0].sum() == sum(
        e.pdfs.size for e in read(f"ark:{sysd['d']}/egs.ark", "xeg").values())


def test_nnet3_chain_acc_lda_stats(sysd):
    p, j, _, _ = run("nnet3-chain-acc-lda-stats",
                     fmt(sysd, "{d}/final.mdl", "ark:{d}/cegs.ark")
                     + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    assert _lda_accs(p)[0].shape == (1, sysd["P"])


def test_nnet3_am_init_and_train_transitions(sysd):
    p, j, _, _ = run("nnet3-am-init", fmt(sysd, "{d}/final.mdl",
                                          "{d}/m1.raw") + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    _, _, out, want = run("nnet3-am-info", [p])
    assert out == want and out.startswith("num-components")
    p2, j2, _, _ = run("nnet3-am-train-transitions",
                       [p] + fmt(sysd, "ark:{d}/ali.ark") + ["{out}"])
    assert raw_bytes(p2) == raw_bytes(j2) != raw_bytes(p)


def test_analyze_counts(sysd):
    p, j, _, _ = run("analyze-counts", fmt(sysd, "ark:{d}/pdf.ark")
                     + ["{out}"])
    assert raw_bytes(p) == raw_bytes(j)
    counts = [int(c) for c in open(p).read().split()[1:-1]]
    assert sum(counts) == sum(len(v) for v in sysd["pdf"].values())


DEVICE_TOOLS = {"nnet3-compute-prob": 2, "nnet3-align-compiled": 5,
                "nnet3-combine": 5, "align-mapped": 4,
                "nnet3-compute-from-egs": 3}


@pytest.mark.parametrize("name", sorted(DEVICE_TOOLS))
def test_tools_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        TOOLS[name]([f"never.read.{i}" for i in range(DEVICE_TOOLS[name])])


def test_every_tool_is_registered():
    names = {"ali-to-pdf", "gmm-info", "lattice-to-nbest", "feat-to-dim",
             "feat-to-len", "nnet3-info", "nnet3-copy", "nnet3-get-egs",
             "nnet3-copy-egs", "nnet3-shuffle-egs", "nnet3-merge-egs",
             "nnet3-compute-prob", "nnet3-align-compiled", "nnet3-combine",
             "nnet3-subset-egs", "nnet3-acc-lda-stats", "align-mapped",
             "nnet3-chain-acc-lda-stats", "nnet3-am-init",
             "nnet3-am-train-transitions", "nnet3-compute-from-egs",
             "nnet3-get-egs-simple", "nnet3-am-info", "analyze-counts"}
    assert len(names) == 24 and names <= set(TOOLS)
    assert names <= set(jtools.TOOLS)
