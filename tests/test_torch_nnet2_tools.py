"""The port's 33 nnet2 tools (cli/tools_bank{19,25,26,30,31}.py), each
run through the port's registry with ``--device=cpu`` on tiny files and
held against the JAX package's tool of the same name on the same files
(the tools that tests/test_cli_bank{19,25,26,30,31}.py cover in the
original), or, for the three parts ported to intent, against the JAX
library path:

* every decode and alignment subtracts the model's log-priors when the
  file has them (the original's nnet-latgen-faster and -parallel drop
  them): held against the JAX package's ``Nnet2Model`` minus the
  log-priors, decoded by its ``_LatgenDecoder``; on a model without
  priors the port's tool equals the JAX tool;
* nnet2-am-copy, nnet-am-copy, nnet-am-average and nnet-am-fix carry the
  priors (the originals drop them): the output equals the JAX tool's
  file with the input's ``<Priors>`` added;
* the online2-wav-nnet2 tools stream through ``NnetStream`` in O(T):
  their rows equal the offline forward of the same MFCCs.

The files are written once by a module fixture: the yes/no task's .mdl,
HCLG and words, three waveforms of 54, 60 and 75 frames and their 13
MFCCs, and nnet2 models written by the JAX tools (nnet-am-init at 2
layers of 64 / 16; nnet-adjust-priors from seeded skewed counts;
nnet-am-mixup), so that everything downstream starts from the JAX
side's files.  The three tools that draw flax's init (nnet-am-init,
nnet-init, nnet-replace-last-layers) are held by shapes, zero biases
and the kernels' scale.  Bars, as in test_torch_serve_tools.py:
matrices within 1e-4 of the largest entry, words and alignments equal,
lattice costs within 1e-4 relative; files byte-equal where the
original's host numpy writes them.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am import nnet2 as tn
from kaldi_tpu_torch.am import raw_nnet as tr
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
# samples: 54, 60 and 75 frames of 25 ms / 10 ms
LENGTHS = (9000, 9840, 12340)
LAT = ("--beam=15", "--lattice-beam=6", "--acoustic-scale=0.5")


def run(name, args, port_opts=CPU, jax=True, tag=""):
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


def read(spec, holder):
    return dict(SequentialTableReader(spec, holder=holder))


def close(got, want, tol=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def same_best(got, want):
    """Two CompactLattice tables: equal keys, best words, costs within
    REL relative."""
    assert sorted(got) == sorted(want)
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        assert list(gw) == list(ww), k
        assert gc == pytest.approx(wc, rel=REL, abs=REL)


def raw_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def with_priors(path, priors, out):
    """The nnet2 file ``path`` rewritten with ``priors`` (the port's
    writer, which the library tests hold byte-equal to the JAX one)."""
    params, cfg, _ = tn.load_nnet2_full(path)
    tn.save_nnet2(out, params, cfg, priors=priors)
    return out


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    from kaldi_tpu_torch.pipelines.egs_io import XentEg
    d = tmp_path_factory.mktemp("nnet2")
    OUT["d"] = str(d)
    lang, tm, HCLG = yesno_graph(PORT, "three_state")
    P = tm.num_pdfs
    write_mdl(f"{d}/final.mdl", tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device="cpu"))
    write_fst_path(f"{d}/HCLG.fst", HCLG)
    lang.words.write(f"{d}/words.txt")
    rng = np.random.default_rng(20)
    waves = {}
    with TableWriter(f"ark:{d}/wav.ark", holder="wav") as w:
        for i, n in enumerate(LENGTHS):
            t = np.arange(n) / 16000.0
            x = 2000 * np.sin(2 * np.pi * (150 + 80 * i) * t) \
                + 300 * rng.standard_normal(n)
            waves[f"utt{i}"] = x.astype(np.int16)
            w[f"utt{i}"] = (waves[f"utt{i}"], 16000)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0)),
                device="cpu")
    feats = {k: mfcc.compute(v.astype(np.float32)).numpy()
             for k, v in waves.items()}
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        for k, v in feats.items():
            w[k] = v
    # the models, from the JAX tools
    for srand, name in ((1, "init"), (2, "init2")):
        assert jtools.main(["nnet-am-init", "--feat-dim=13",
                            f"--num-pdfs={P}", "--num-hidden-layers=2",
                            "--pnorm-input-dim=64", "--pnorm-output-dim=16",
                            f"--srand={srand}", f"{d}/{name}.mdl"]) == 0
    counts = rng.gamma(0.3, size=P) * 100.0
    with kio.open_wxfilename(f"{d}/counts.vec") as f:
        kio.init_kaldi_output_stream(f)
        kio.write_vector(f, counts)
    assert jtools.main(["nnet-adjust-priors", f"{d}/init.mdl",
                        f"{d}/counts.vec", f"{d}/pri.mdl"]) == 0
    assert jtools.main(["nnet-am-mixup", f"--num-mixtures={P + 9}",
                        "--srand=3", f"{d}/pri.mdl", f"{d}/mix.mdl"]) == 0
    # egs (pre-spliced windows) and training graphs
    with TableWriter(f"ark:{d}/egs.ark", holder="xeg") as w:
        for i in range(2):
            w[f"eg{i}"] = XentEg(
                feats=rng.standard_normal((2, 4, 65)).astype(np.float32),
                pdfs=rng.integers(0, P, (2, 4)).astype(np.int32))
    with open(f"{d}/lexicon.txt", "w") as f:
        f.write("YES Y EH S\nNO N OW\n")
    with TableWriter(f"ark,t:{d}/text", holder="text") as w:
        for k, words in zip(sorted(waves), (["YES", "NO"], ["NO"],
                                            ["YES", "YES", "NO"])):
            w[k] = words
    assert jtools.main(["compile-train-graphs", f"{d}/lexicon.txt",
                        f"{d}/final.mdl", f"ark,t:{d}/text",
                        f"ark:{d}/graphs.ark"]) == 0
    return {"d": str(d), "lang": lang, "tm": tm, "P": P, "waves": waves,
            "feats": feats, "counts": counts}


def fmt(s, *args):
    return [a.replace("{d}", s["d"]) for a in args]


def jax_scores(path, feats, priors=True):
    """The JAX library path: ``Nnet2Model`` on ``feats``, minus the
    log-priors when asked and present."""
    import jax.numpy as jnp
    from kaldi_tpu.am.nnet2 import Nnet2Model, load_nnet2_full
    params, cfg, pri = load_nnet2_full(path)
    out = {}
    for k, x in feats.items():
        ll = np.asarray(Nnet2Model(cfg).apply(
            {"params": params}, jnp.asarray(x)[None]))[0]
        if priors and pri is not None:
            ll = ll - tn.log_priors(pri)[None, :]
        out[k] = ll.astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# forward tools

@pytest.mark.parametrize("name", ["nnet2-compute", "nnet-compute"])
@pytest.mark.parametrize("model", ["pri", "mix"])
def test_compute(sysd, name, model):
    p, j, _, _ = run(name, fmt(sysd, f"{{d}}/{model}.mdl",
                               "ark:{d}/feats.ark") + ["ark:{out}"],
                     tag=model)
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    lib = jax_scores(f"{sysd['d']}/{model}.mdl", sysd["feats"],
                     priors=False)
    assert sorted(got) == sorted(want) == sorted(lib)
    for k in want:
        close(got[k], want[k])
        close(got[k], lib[k])


@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("model", ["pri", "mix"])
def test_nnet_am_compute(sysd, divide, model):
    opts = ["--divide-by-priors=true"] if divide else []
    p, j, _, _ = run("nnet-am-compute",
                     opts + fmt(sysd, f"{{d}}/{model}.mdl",
                                "ark:{d}/feats.ark") + ["ark:{out}"],
                     tag=f"{model}{divide}")
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    lib = jax_scores(f"{sysd['d']}/{model}.mdl", sysd["feats"],
                     priors=divide)
    for k in lib:
        close(got[k], want[k])
        close(got[k], lib[k])


def test_nnet_am_compute_needs_priors_to_divide(sysd):
    d = sysd["d"]
    with pytest.raises(KaldiError, match="no priors"):
        TOOLS["nnet-am-compute"]([*CPU, "--divide-by-priors=true",
                                  f"{d}/init.mdl", f"ark:{d}/feats.ark",
                                  f"ark:{d}/never.ark"])


@pytest.mark.parametrize("model", ["init", "mix"])
def test_nnet_compute_prob(sysd, model):
    _, _, pout, jout = run("nnet-compute-prob",
                           fmt(sysd, f"{{d}}/{model}.mdl",
                               "ark:{d}/egs.ark"))
    assert float(pout) == pytest.approx(float(jout), rel=REL, abs=1e-5)


def test_nnet_compute_from_egs(sysd):
    p, j, _, _ = run("nnet-compute-from-egs",
                     fmt(sysd, "{d}/mix.mdl", "ark:{d}/egs.ark")
                     + ["ark:{out}"])
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(want) == ["eg0", "eg1"]
    for k in want:
        assert got[k].shape == (8, sysd["P"])
        close(got[k], want[k])


# ---------------------------------------------------------------------------
# decodes and alignment: priors subtracted where the file has them

def jax_lattices(sysd, scores):
    """The JAX package's _LatgenDecoder over ``scores`` at LAT."""
    from kaldi_tpu.am.serialize import read_mdl as jread_mdl
    from kaldi_tpu.cli.tools import _LatgenDecoder, _load_hclg
    d = sysd["d"]
    tm, _ = jread_mdl(f"{d}/final.mdl")
    dec = _LatgenDecoder(_load_hclg(f"{d}/HCLG.fst"), tm.tid_to_pdf_array,
                         15.0, 6.0, 0.5, max_active=7000)
    return {k: dec.decode_to_clat(v) for k, v in scores.items()}


@pytest.fixture(scope="module")
def lib_lattices(sysd):
    return {m: jax_lattices(sysd, jax_scores(f"{sysd['d']}/{m}.mdl",
                                             sysd["feats"]))
            for m in ("pri", "mix")}


LATGEN = {"nnet-latgen-faster": [],
          "nnet-latgen-faster-parallel": ["--num-threads=3"]}


@pytest.mark.parametrize("name", sorted(LATGEN))
def test_latgen_without_priors_equals_the_jax_tool(sysd, name):
    args = [*LAT, *LATGEN[name],
            *fmt(sysd, "{d}/final.mdl", "{d}/init.mdl", "{d}/HCLG.fst",
                 "ark:{d}/feats.ark"), "ark:{out}"]
    p, j, _, _ = run(name, args, tag="init")
    same_best(read(f"ark:{p}", "clat"), read(f"ark:{j}", "clat"))


@pytest.mark.parametrize("name", sorted(LATGEN))
@pytest.mark.parametrize("model", ["pri", "mix"])
def test_latgen_divides_by_the_priors(sysd, lib_lattices, name, model):
    """To intent: the JAX tool decodes raw log-posteriors; the port's
    equals the JAX library path with the log-priors subtracted."""
    args = [*LAT, *LATGEN[name],
            *fmt(sysd, "{d}/final.mdl", f"{{d}}/{model}.mdl",
                 "{d}/HCLG.fst", "ark:{d}/feats.ark"), "ark:{out}"]
    p, j, _, _ = run(name, args, tag=model)
    got = read(f"ark:{p}", "clat")
    same_best(got, lib_lattices[model])
    # the priors matter here: the JAX tool's lattices score otherwise
    raw = read(f"ark:{j}", "clat")
    assert any(abs(got[k].best_path()[2] - raw[k].best_path()[2]) > 1e-2
               for k in got)


def test_latgen_parallel_equals_serial(sysd):
    outs = []
    for name in sorted(LATGEN):
        p, _, _, _ = run(name, [*LAT, *LATGEN[name], *fmt(
            sysd, "{d}/final.mdl", "{d}/pri.mdl", "{d}/HCLG.fst",
            "ark:{d}/feats.ark"), "ark:{out}"], jax=False, tag="serial")
        outs.append(read(f"ark:{p}", "clat"))
    same_best(*outs)


@pytest.mark.parametrize("model", ["init", "pri"])
def test_nnet_align_compiled(sysd, model):
    p, j, _, _ = run("nnet-align-compiled",
                     ["--acoustic-scale=0.5",
                      *fmt(sysd, "{d}/final.mdl", f"{{d}}/{model}.mdl",
                           "ark:{d}/graphs.ark", "ark:{d}/feats.ark"),
                      "ark:{out}"], tag=model)
    got, want = read(f"ark:{p}", "ivec"), read(f"ark:{j}", "ivec")
    assert sorted(got) == sorted(want) == sorted(sysd["feats"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert len(got[k]) == len(sysd["feats"][k])


# ---------------------------------------------------------------------------
# online2 nnet2 streaming

def test_online2_am_compute_streams_the_offline_rows(sysd):
    p, j, _, _ = run("online2-wav-nnet2-am-compute",
                     ["--chunk-length=0.05",
                      *fmt(sysd, "{d}/mix.mdl", "ark:{d}/wav.ark"),
                      "ark:{out}"])
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    q, _, _, _ = run("nnet2-compute", fmt(sysd, "{d}/mix.mdl",
                                          "ark:{d}/feats.ark")
                     + ["ark:{out}"], jax=False, tag="offline")
    offline = read(f"ark:{q}", "mat")
    for k in sysd["feats"]:
        close(got[k], want[k])
        close(got[k], offline[k])


@pytest.mark.parametrize("chunk", ["0.03", "0.18"])
def test_stream_rows_equal_the_forward_in_linear_work(sysd, chunk):
    """The pump forwards each frame once plus the splice's context a
    chunk (the original's forwarded every frame so far at each chunk)."""
    from kaldi_tpu_torch.cli.online2 import online_mfcc
    from kaldi_tpu_torch.cli.tools_bank30 import nnet2_stream
    params, cfg, _ = tn.load_nnet2_full(f"{sysd['d']}/mix.mdl")
    model = tn.nnet2_model(params, cfg, "cpu")
    seen = []
    orig = model.forward
    model.forward = lambda x: (seen.append(x.shape[1]), orig(x))[1]
    mfcc = online_mfcc(16000.0, "cpu")
    wave = sysd["waves"]["utt2"]
    step = int(float(chunk) * 16000)
    rows = []
    nnet2_stream(mfcc, model, wave, step, "cpu", rows.append)
    with torch.no_grad():
        want = orig(torch.from_numpy(sysd["feats"]["utt2"])[None])[0]
    close(torch.cat(rows).numpy(), want.numpy())
    T = len(sysd["feats"]["utt2"])
    assert sum(seen) <= T + 4 * len(seen)


def _online_words(sysd, name, model, extra=(), jax=True, tag=""):
    args = [*extra, "--acoustic-scale=0.5", "--chunk-length=0.1",
            *fmt(sysd, "--word-symbol-table={d}/words.txt", "{d}/final.mdl",
                 f"{{d}}/{model}.mdl", "{d}/HCLG.fst", "ark:{d}/wav.ark"),
            "ark,t:{out}"]
    p, j, _, _ = run(name, args, jax=jax, tag=model + tag)
    return read(f"ark,t:{p}", "text"), (read(f"ark,t:{j}", "text")
                                        if jax else None)


ONLINE = {"online2-wav-nnet2-latgen-faster": (),
          "online2-wav-nnet2-latgen-threaded": ("--num-threads=3",)}


@pytest.mark.parametrize("name", sorted(ONLINE))
@pytest.mark.parametrize("model", ["init", "pri", "mix"])
def test_online2_decode_equals_the_jax_tool(sysd, name, model):
    got, want = _online_words(sysd, name, model, ONLINE[name])
    assert got == want
    assert sorted(got) == sorted(sysd["waves"])


def test_online2_threaded_equals_serial_and_the_offline_decode(sysd):
    """Threads share the model, the MFCC computer and the decoder's
    tables: their words equal the serial tool's and the offline decode
    of the same scores."""
    from kaldi_tpu_torch.cli.tools_bank19 import (latgen_inputs,
                                                  load_nnet2_scorer,
                                                  nnet2_scores)
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    serial, _ = _online_words(sysd, "online2-wav-nnet2-latgen-faster",
                              "pri", jax=False, tag="s")
    threaded, _ = _online_words(sysd, "online2-wav-nnet2-latgen-threaded",
                                "pri", ("--num-threads=3",), jax=False,
                                tag="t")
    assert threaded == serial
    d = sysd["d"]
    tm, HCLG = latgen_inputs(f"{d}/final.mdl", f"{d}/HCLG.fst")
    model, _, logpri = load_nnet2_scorer(f"{d}/pri.mdl", "cpu")
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=15.0, acoustic_scale=0.5),
                       device="cpu")
    for k, x in sysd["feats"].items():
        _t, ols, _c = dec.decode(nnet2_scores(model, x, "cpu", logpri))
        assert serial[k] == [sysd["lang"].words.find(o) for o in ols], k


@pytest.mark.parametrize("name", ["online2-wav-nnet2-latgen-threaded",
                                  "nnet-latgen-faster-parallel"])
def test_threads_under_a_short_switch_interval(sysd, name):
    """More threads than utterances, the interpreter switching every
    microsecond: each utterance's result equals the serial tool's (a
    shared model, MFCC computer or decoder table that threads corrupted
    would show here)."""
    import sys
    serial = {"online2-wav-nnet2-latgen-threaded":
              "online2-wav-nnet2-latgen-faster",
              "nnet-latgen-faster-parallel": "nnet-latgen-faster"}[name]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        if name.startswith("online2"):
            got, _ = _online_words(sysd, name, "pri", ("--num-threads=8",),
                                   jax=False, tag="stress")
        else:
            p, _, _, _ = run(name, [*LAT, "--num-threads=8", *fmt(
                sysd, "{d}/final.mdl", "{d}/pri.mdl", "{d}/HCLG.fst",
                "ark:{d}/feats.ark"), "ark:{out}"], jax=False, tag="stress")
            got = read(f"ark:{p}", "clat")
    finally:
        sys.setswitchinterval(old)
    if name.startswith("online2"):
        want, _ = _online_words(sysd, serial, "pri", jax=False, tag="ref")
        assert got == want
    else:
        q, _, _, _ = run(serial, [*LAT, *fmt(
            sysd, "{d}/final.mdl", "{d}/pri.mdl", "{d}/HCLG.fst",
            "ark:{d}/feats.ark"), "ark:{out}"], jax=False, tag="ref")
        same_best(got, read(f"ark:{q}", "clat"))


# ---------------------------------------------------------------------------
# model tools: info, init, copies

def test_nnet_am_info(sysd):
    _, _, pout, jout = run("nnet-am-info", fmt(sysd, "{d}/mix.mdl"),
                         port_opts=())
    assert pout == jout and "num-hidden-layers 2" in pout


def check_flax_init(got, want):
    """Shapes and dtypes equal, biases zero, kernels at lecun_normal's
    scale."""
    lg, lw = list(leaves(got)), list(leaves(want))
    assert [(k, v.shape, v.dtype) for k, v in lg] == \
        [(k, v.shape, v.dtype) for k, v in lw]
    for (k, v), (_, w) in zip(lg, lw):
        if k[-1] == "bias":
            assert not v.any() and not w.any(), k
        else:
            fan_in = v.shape[0]
            assert np.std(v) * np.sqrt(fan_in) == pytest.approx(
                np.std(w) * np.sqrt(fan_in), rel=0.25), k
            assert np.abs(v).max() <= 2.0 / 0.8796 / np.sqrt(fan_in) + 1e-6


def test_nnet_am_init(sysd):
    P = sysd["P"]
    p, j, _, _ = run("nnet-am-init",
                     ["--feat-dim=13", f"--num-pdfs={P}",
                      "--num-hidden-layers=2", "--pnorm-input-dim=64",
                      "--pnorm-output-dim=16", "--srand=5", "{out}"],
                     port_opts=())
    (gp, gc, gpr), (wp, wc, wpr) = tn.load_nnet2_full(p), \
        tn.load_nnet2_full(j)
    assert gc == wc and gpr is None and wpr is None
    check_flax_init(gp, wp)


@pytest.mark.parametrize("name", ["nnet2-am-copy", "nnet-am-copy"])
@pytest.mark.parametrize("model", ["init", "pri", "mix"])
def test_am_copy_carries_the_priors(sysd, name, model):
    """Without priors the JAX tool's bytes; with them, to intent, the
    input's bytes (the JAX tool's file plus the input's priors)."""
    src = f"{sysd['d']}/{model}.mdl"
    p, j, _, _ = run(name, [src, "{out}"], port_opts=(), tag=model)
    if model == "init":
        assert raw_bytes(p) == raw_bytes(j)
    else:
        assert raw_bytes(p) == raw_bytes(src)
        pri = tn.load_nnet2_full(src)[2]
        assert raw_bytes(p) == raw_bytes(with_priors(j, pri, j + ".pri"))


@pytest.mark.parametrize("first", ["init", "pri"])
def test_nnet_am_average(sysd, first):
    """Equal to the JAX tool's average, with the first input's priors
    (to intent)."""
    d = sysd["d"]
    p, j, _, _ = run("nnet-am-average",
                     ["{out}", f"{d}/{first}.mdl", f"{d}/init2.mdl"],
                     port_opts=(), tag=first)
    pri = tn.load_nnet2_full(f"{d}/{first}.mdl")[2]
    if pri is None:
        assert raw_bytes(p) == raw_bytes(j)
    else:
        assert raw_bytes(p) == raw_bytes(with_priors(j, pri, j + ".pri"))
        np.testing.assert_array_equal(tn.load_nnet2_full(p)[2], pri)


@pytest.mark.parametrize("model", ["broken", "broken_pri"])
def test_nnet_am_fix(sysd, model):
    d = sysd["d"]
    params, cfg, pri = tn.load_nnet2_full(f"{d}/pri.mdl")
    params["pnorm1"]["affine"]["kernel"][0, :3] = [np.nan, np.inf, 50.0]
    params["output_affine"]["bias"][1] = -40.0
    tn.save_nnet2(f"{d}/{model}.mdl", params, cfg,
                  priors=pri if model == "broken_pri" else None)
    p, j, _, _ = run("nnet-am-fix", ["--max-param-value=10",
                                     f"{d}/{model}.mdl", "{out}"],
                     port_opts=(), tag=model)
    got = tn.load_nnet2_full(p)
    k = got[0]["pnorm1"]["affine"]["kernel"]
    assert list(k[0, :3]) == [0.0, 0.0, 10.0]
    if model == "broken":
        assert raw_bytes(p) == raw_bytes(j)
    else:
        assert raw_bytes(p) == raw_bytes(with_priors(j, pri, j + ".pri"))


# ---------------------------------------------------------------------------
# raw nets

def test_nnet_init(sysd):
    d = sysd["d"]
    with open(f"{d}/nnet.config", "w") as f:
        f.write("# p-norm net\nfeat-dim = 13\nnum_pdfs = 9\n"
                "num-hidden-layers = 2\npnorm-input-dim = 48\n"
                "pnorm-output-dim = 12\nsplice = -1 0 1\n")
    p, j, _, _ = run("nnet-init", ["--srand=3", f"{d}/nnet.config",
                                   "{out}"], port_opts=())
    got, want = tr.load_raw_nnet(p), tr.load_raw_nnet(j)
    assert [c for c, _ in got] == [c for c, _ in want]
    gtree = {str(i): dict(v) for i, (_c, v) in enumerate(got)
             if _c == "affine"}
    wtree = {str(i): dict(v) for i, (_c, v) in enumerate(want)
             if _c == "affine"}
    check_flax_init(gtree, wtree)
    for (c, a), (_, b) in zip(got, want):
        if c != "affine":
            for (ka, va), (kb, vb) in zip(leaves(a), leaves(b)):
                assert ka == kb
                np.testing.assert_array_equal(va, vb)


def test_nnet_to_raw_nnet(sysd):
    d = sysd["d"]
    p, j, _, _ = run("nnet-to-raw-nnet", [f"{d}/pri.mdl", "{out}"],
                     port_opts=())
    assert raw_bytes(p) == raw_bytes(j)
    # the raw net's forward equals the model's log-posteriors
    comps = tr.load_raw_nnet(p)
    lib = jax_scores(f"{d}/pri.mdl", sysd["feats"], priors=False)
    for k, x in sysd["feats"].items():
        close(tr.forward(comps, x, "cpu").numpy(), lib[k])
    for main in (ttools.main, jtools.main):
        assert main(["nnet-to-raw-nnet", f"{d}/mix.mdl",
                     f"{d}/never.raw"]) == 1


@pytest.fixture(scope="module")
def raw(sysd):
    d = sysd["d"]
    assert jtools.main(["nnet-to-raw-nnet", f"{d}/pri.mdl",
                        f"{d}/pri.raw"]) == 0
    return f"{d}/pri.raw"


@pytest.mark.parametrize("truncate", [-1, 0, 3])
def test_raw_nnet_copy(sysd, raw, truncate):
    p, j, _, _ = run("raw-nnet-copy", [f"--truncate={truncate}", raw,
                                       "{out}"], port_opts=(),
                     tag=str(truncate))
    assert raw_bytes(p) == raw_bytes(j)


def test_raw_nnet_info(sysd, raw):
    _, _, pout, jout = run("raw-nnet-info", [raw], port_opts=())
    assert pout == jout and "component 2 : pnorm output-dim 16 p 2" in pout


def test_raw_nnet_concat(sysd, raw):
    d = sysd["d"]
    assert jtools.main(["raw-nnet-copy", "--truncate=1", raw,
                        f"{d}/splice.raw"]) == 0
    p, j, _, _ = run("raw-nnet-concat", [raw, f"{d}/splice.raw", "{out}"],
                     port_opts=())
    assert raw_bytes(p) == raw_bytes(j)
    assert len(tr.load_raw_nnet(p)) == len(tr.load_raw_nnet(raw)) + 1
    # an affine boundary that does not fit fails on both sides
    for main in (ttools.main, jtools.main):
        assert main(["raw-nnet-concat", raw, raw, f"{d}/never.raw"]) == 1


# ---------------------------------------------------------------------------
# progress, priors, transitions

@pytest.mark.parametrize("probe", [False, True])
def test_nnet_show_progress(sysd, probe):
    d = sysd["d"]
    args = [f"{d}/init.mdl", f"{d}/init2.mdl"] + (
        [f"ark:{d}/egs.ark"] if probe else [])
    _, _, pout, jout = run("nnet-show-progress", args, tag=str(probe))
    plines, jlines = pout.splitlines(), jout.splitlines()
    assert len(plines) == len(jlines) == 6 + 2 * probe
    assert plines[:6] == jlines[:6]
    for a, b in zip(plines[6:], jlines[6:]):
        assert a.split()[0] == b.split()[0]
        assert float(a.split()[1]) == pytest.approx(float(b.split()[1]),
                                                    rel=REL, abs=1e-5)


def test_nnet_adjust_priors(sysd):
    d = sysd["d"]
    p, j, _, _ = run("nnet-adjust-priors",
                     [f"{d}/mix.mdl", f"{d}/counts.vec", "{out}"],
                     port_opts=())
    assert raw_bytes(p) == raw_bytes(j)


def test_nnet_train_transitions(sysd):
    d = sysd["d"]
    assert jtools.main(["nnet-align-compiled", "--acoustic-scale=0.5",
                        f"{d}/final.mdl", f"{d}/pri.mdl",
                        f"ark:{d}/graphs.ark", f"ark:{d}/feats.ark",
                        f"ark:{d}/ali.ark"]) == 0
    from kaldi_tpu_torch.am.serialize import (read_transition_model,
                                              write_transition_model)
    with kio.open_wxfilename(f"{d}/final.tm") as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, sysd["tm"])
    p, j, _, _ = run("nnet-train-transitions",
                     [f"{d}/final.tm", f"ark:{d}/ali.ark", f"{d}/mix.mdl",
                      "{out}.tm", "{out}.mdl"], port_opts=())
    assert raw_bytes(p + ".tm") == raw_bytes(j + ".tm")
    assert raw_bytes(p + ".mdl") == raw_bytes(j + ".mdl")
    with kio.open_rxfilename(p + ".tm") as f:
        kio.init_kaldi_input_stream(f)
        read_transition_model(f)


# ---------------------------------------------------------------------------
# model surgery

SURGERY = {
    "nnet-insert": ["--srand=4", "--stddev-factor=0.2"],
    "nnet-am-widen": ["--hidden-layer-dim=96", "--srand=4"],
    "nnet-am-switch-preconditioning": [],
    "nnet-am-limit-rank": ["--dim=5"],
}


@pytest.mark.parametrize("name", ["nnet-insert", "nnet-am-widen",
                                  "nnet-am-switch-preconditioning"])
@pytest.mark.parametrize("model", ["pri", "mix"])
def test_surgery_equals_the_jax_tool(sysd, name, model):
    p, j, _, _ = run(name, [*SURGERY[name], f"{sysd['d']}/{model}.mdl",
                            "{out}"], port_opts=(), tag=model)
    assert raw_bytes(p) == raw_bytes(j)
    # the result still forwards
    params, cfg, _ = tn.load_nnet2_full(p)
    with torch.no_grad():
        out = tn.nnet2_model(params, cfg, "cpu")(
            torch.from_numpy(sysd["feats"]["utt0"])[None])
    assert out.shape[-1] == sysd["P"] and torch.isfinite(out).all()


@pytest.mark.parametrize("value", ["true", "false"])
def test_nnet_am_switch_preconditioning(sysd, value):
    p, j, _, _ = run("nnet-am-switch-preconditioning",
                     [f"--preconditioned={value}", f"{sysd['d']}/pri.mdl",
                      "{out}"], port_opts=(), tag=value)
    assert raw_bytes(p) == raw_bytes(j)
    assert tn.load_nnet2(p)[1].preconditioned == (value == "true")


@pytest.mark.parametrize("srand", [0, 7])
def test_nnet_am_mixup(sysd, srand):
    P = sysd["P"]
    for model in ("init", "pri"):
        p, j, _, _ = run("nnet-am-mixup",
                         [f"--num-mixtures={P + 13}", f"--srand={srand}",
                          f"{sysd['d']}/{model}.mdl", "{out}"],
                         port_opts=(), tag=f"{model}{srand}")
        assert raw_bytes(p) == raw_bytes(j)
        assert len(tn.load_nnet2(p)[1].mix2pdf) == P + 13


@pytest.mark.parametrize("opts", [["--dim=5"],
                                  ["--parameter-proportion=0.5"]])
def test_nnet_am_limit_rank(sysd, opts):
    """SVD factors' signs are free: the reduced products are compared."""
    p, j, _, _ = run("nnet-am-limit-rank", [*opts, f"{sysd['d']}/pri.mdl",
                                            "{out}"], port_opts=(),
                     tag=opts[0][2:6])
    (gp, gc, gpr), (wp, wc, wpr) = tn.load_nnet2_full(p), \
        tn.load_nnet2_full(j)
    assert gc == wc
    np.testing.assert_array_equal(gpr, wpr)
    for (k, a), (_, b) in zip(leaves(gp), leaves(wp)):
        close(a, b, 1e-5)
    k = np.asarray(gp["pnorm2"]["affine"]["kernel"], np.float64)
    want_rank = 5 if opts == ["--dim=5"] else int(0.5 * 16 * 64 / 80)
    assert np.linalg.matrix_rank(k, tol=1e-4 * np.abs(k).max()) == \
        want_rank


def test_nnet_am_reinitialize(sysd):
    p, j, _, _ = run("nnet-am-reinitialize",
                     ["--srand=6", f"{sysd['d']}/mix.mdl",
                      f"{sysd['d']}/final.mdl", "{out}"], port_opts=())
    assert raw_bytes(p) == raw_bytes(j)
    cfg = tn.load_nnet2(p)[1]
    assert cfg.mix2pdf is None and cfg.num_pdfs == sysd["P"]


def test_nnet_replace_last_layers(sysd):
    d = sysd["d"]
    p, j, _, _ = run("nnet-replace-last-layers",
                     ["--num-layers-to-remove=1", "--num-pdfs=11",
                      "--srand=2", f"{d}/mix.mdl", "{out}"], port_opts=())
    (gp, gc, gpr), (wp, wc, wpr) = tn.load_nnet2_full(p), \
        tn.load_nnet2_full(j)
    assert gc == wc and gc.num_pdfs == 11 and gc.mix2pdf is None
    assert gpr is None and wpr is None
    src = tn.load_nnet2(f"{d}/mix.mdl")[0]
    for (k, a), (_, b), (_, s) in zip(leaves(gp["pnorm1"]),
                                      leaves(wp["pnorm1"]),
                                      leaves(src["pnorm1"])):
        np.testing.assert_array_equal(a, s)
        np.testing.assert_array_equal(b, s)
    check_flax_init({k: gp[k] for k in ("pnorm2", "output_affine")},
                    {k: wp[k] for k in ("pnorm2", "output_affine")})


def test_nnet_modify_learning_rates(sysd):
    d = sysd["d"]
    p, j, _, _ = run("nnet-modify-learning-rates",
                     ["--average-learning-rate=0.001",
                      "--last-layer-factor=0.5", f"{d}/init.mdl",
                      f"{d}/init2.mdl", "{out}"], port_opts=())
    assert raw_bytes(p) == raw_bytes(j)
    assert len(tn.load_nnet2(p)[1].learn_rates) == 3


# ---------------------------------------------------------------------------
# the card by default

DEVICE_TOOLS = ("nnet2-compute", "nnet-compute", "nnet-am-compute",
                "nnet-compute-prob", "nnet-compute-from-egs",
                "nnet-show-progress", "nnet-latgen-faster",
                "nnet-latgen-faster-parallel", "nnet-align-compiled",
                "online2-wav-nnet2-latgen-faster",
                "online2-wav-nnet2-latgen-threaded",
                "online2-wav-nnet2-am-compute")


@pytest.mark.parametrize("name", DEVICE_TOOLS)
def test_tools_default_to_the_card(sysd, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = sysd["d"]
    args = {"nnet-show-progress": [f"{d}/init.mdl", f"{d}/init.mdl"]}.get(
        name, [f"{d}/final.mdl", f"{d}/pri.mdl", f"{d}/HCLG.fst",
               f"ark:{d}/wav.ark", f"ark:{d}/never.ark"])
    with pytest.raises(KaldiError, match="no CUDA card"):
        TOOLS[name](args)


def test_every_tool_is_registered():
    names = {"online2-wav-nnet2-latgen-faster",
             "online2-wav-nnet2-latgen-threaded",
             "online2-wav-nnet2-am-compute", "nnet-latgen-faster",
             "nnet2-compute", "nnet-compute", "nnet-am-compute",
             "nnet-latgen-faster-parallel", "nnet-align-compiled",
             "nnet-compute-prob", "nnet-compute-from-egs", "nnet-am-info",
             "nnet-am-init", "nnet2-am-copy", "nnet-am-average",
             "nnet-am-copy", "nnet-am-fix", "nnet-init", "nnet-to-raw-nnet",
             "raw-nnet-copy", "raw-nnet-info", "raw-nnet-concat",
             "nnet-show-progress", "nnet-train-transitions",
             "nnet-adjust-priors", "nnet-insert",
             "nnet-replace-last-layers", "nnet-am-widen", "nnet-am-mixup",
             "nnet-am-switch-preconditioning", "nnet-am-limit-rank",
             "nnet-am-reinitialize", "nnet-modify-learning-rates"}
    assert len(names) == 33 and names <= set(TOOLS)
    assert names <= set(jtools.TOOLS)
