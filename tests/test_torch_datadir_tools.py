"""The port's bank-4 tools (cli/tools_bank4.py: the utils/ data-directory
scripts, sym2int / int2sym, segment-long-utterances, copy-vector,
vector-sum, wav-copy) and its copy of pipelines/segment.py, held against
the JAX package's tools and module of the same names on the same files.

Every tool runs through the port's registry (``--device=cpu`` for
segment-long-utterances, whose energy VAD is a device function) and
through the JAX package's on a copy of the same inputs; the files they
write must be byte-equal, and so must their exit codes and what they
print.  ``segment_frames`` and ``segment_long_audio`` are held against
the original on seeded VAD masks and waves (islands merged across short
gaps, over-long runs split at their longest pause or in half, short
ones dropped), and the segments files ``write_segments`` gives must be
byte-equal.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.pipelines import segment as jseg
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.table import TableWriter
from kaldi_tpu_torch.pipelines import segment as tseg
from kaldi_tpu_torch.pipelines.datadir import DataDir, write_data_dir

torch.set_num_threads(1)

CPU = ("--device=cpu",)


def tree_bytes(path):
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for root, _dirs, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


def both(tmp_path, name, args, port_opts=(), inputs=None, tag=""):
    """Run ``name`` on the port and on the JAX package.  ``{in}`` in args
    is a per-side copy of the directory ``inputs`` (so tools that write
    into their input see their own copy), ``{out}`` a per-side output
    path.  → {side: (rc, stdout, in path, out path)}."""
    res = {}
    for side, main, extra in (("port", ttools.main, port_opts),
                              ("jax", jtools.main, ())):
        src = None
        if inputs is not None:
            src = str(tmp_path / f"in{tag}.{side}")
            shutil.copytree(inputs, src)
        out = str(tmp_path / f"out{tag}.{side}")
        argv = [a.replace("{in}", src or "").replace("{out}", out)
                for a in args]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([name, *extra, *argv])
        res[side] = (rc, buf.getvalue(), src, out)
    return res


def same_files(res, which):
    """The two sides' files at ``which`` (2: the input copy, 3: the
    output) are byte-equal: a file, or every file of a directory."""
    p, j = res["port"][which], res["jax"][which]
    if os.path.isdir(j):
        got, want = tree_bytes(p), tree_bytes(j)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == want[k], k
    else:
        with open(p, "rb") as f, open(j, "rb") as g:
            assert f.read() == g.read()


def make_dir(path, n_spk=4, per_spk=5, seed=0):
    """A data directory of ``n_spk`` speakers with ``per_spk`` .. 1 fewer
    utterances each (seeded), transcripts drawn from a small vocabulary,
    wav.scp commands, and segments of two recordings a speaker."""
    rng = np.random.default_rng(seed)
    words = ["YES", "NO", "MAYBE", "HELLO", "WORLD"]
    utt2spk, text, wav, segs = {}, {}, {}, {}
    for s in range(n_spk):
        n = per_spk - int(rng.integers(0, 2))
        for i in range(n):
            u = f"spk{s}-utt{i}"
            utt2spk[u] = f"spk{s}"
            text[u] = list(rng.choice(words, int(rng.integers(1, 4))))
            reco = f"spk{s}-reco{i % 2}"
            wav[reco] = f"sox /corpus/{reco}.flac -t wav - |"
            tb = round(float(rng.uniform(0, 5)), 2)
            segs[u] = (reco, tb, round(tb + float(rng.uniform(0.5, 3)), 2))
    d = DataDir(wav_scp=wav, text=text, utt2spk=utt2spk, segments=segs)
    write_data_dir(str(path), d)
    return str(path)


@pytest.fixture
def ddir(tmp_path):
    return make_dir(tmp_path / "data")


# ---------------------------------------------------------------------------
# utils/ data-directory scripts

@pytest.mark.parametrize("to_file", [True, False])
def test_utt2spk_to_spk2utt(tmp_path, ddir, to_file):
    res = both(tmp_path, "utt2spk-to-spk2utt",
               [f"{ddir}/utt2spk"] + (["{out}"] if to_file else []))
    assert res["port"][:2] == res["jax"][:2]
    assert res["port"][0] == 0
    if to_file:
        same_files(res, 3)
        with open(res["port"][3]) as f, open(f"{ddir}/spk2utt") as g:
            assert f.read() == g.read()
    else:
        assert res["port"][1].count("\n") == 4


@pytest.mark.parametrize("to_file", [True, False])
def test_spk2utt_to_utt2spk(tmp_path, ddir, to_file):
    res = both(tmp_path, "spk2utt-to-utt2spk",
               [f"{ddir}/spk2utt"] + (["{out}"] if to_file else []))
    assert res["port"][:2] == res["jax"][:2]
    if to_file:
        same_files(res, 3)
        with open(res["port"][3]) as f, open(f"{ddir}/utt2spk") as g:
            assert f.read() == g.read()


def _drop_line(path, i=1):
    with open(path) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:i] + lines[i + 1:]) + "\n")


@pytest.mark.parametrize("broken", ["none", "text", "segments", "wav.scp",
                                    "no-text"])
def test_validate_data_dir(tmp_path, ddir, broken):
    opts = []
    if broken == "no-text":
        os.remove(f"{ddir}/text")
        opts = ["--no-text"]
    elif broken != "none":
        _drop_line(f"{ddir}/{broken}")
    res = both(tmp_path, "validate-data-dir", opts + [ddir])
    assert res["port"][:2] == res["jax"][:2]
    assert res["port"][0] == (0 if broken in ("none", "no-text") else 1)


@pytest.mark.parametrize("broken", ["text", "segments", "wav.scp"])
@pytest.mark.parametrize("in_place", [True, False])
def test_fix_data_dir(tmp_path, ddir, broken, in_place):
    _drop_line(f"{ddir}/{broken}", 2)
    res = both(tmp_path, "fix-data-dir",
               ["{in}"] + ([] if in_place else ["{out}"]), inputs=ddir)
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 2 if in_place else 3)
    d = res["port"][2 if in_place else 3]
    assert ttools.main(["validate-data-dir", d]) == 0


@pytest.mark.parametrize("sel", ["--first-n=7", "--per-spk=2",
                                 "--spk-list", "--utt-list"])
def test_subset_data_dir(tmp_path, ddir, sel):
    if sel == "--spk-list":
        (tmp_path / "spks").write_text("spk3\nspk1\n")
        sel = f"--spk-list={tmp_path}/spks"
    elif sel == "--utt-list":
        (tmp_path / "utts").write_text("spk0-utt1 spk2-utt0\nspk3-utt3\n")
        sel = f"--utt-list={tmp_path}/utts"
    res = both(tmp_path, "subset-data-dir", [sel, ddir, "{out}"])
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 3)


def test_subset_data_dir_needs_a_selection(tmp_path, ddir):
    for tools in (ttools.TOOLS, jtools.TOOLS):
        with pytest.raises(Exception, match="no selection flag"):
            tools["subset-data-dir"]([ddir, str(tmp_path / "never")])


@pytest.mark.parametrize("nj", [1, 2, 3, 4])
def test_split_data(tmp_path, ddir, nj):
    res = both(tmp_path, "split-data", ["{in}", str(nj)], inputs=ddir)
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 2)
    assert len(os.listdir(f"{res['port'][2]}/split{nj}")) == nj


# ---------------------------------------------------------------------------
# sym2int / int2sym

@pytest.fixture
def symtab(tmp_path):
    (tmp_path / "words.txt").write_text(
        "<eps> 0\nYES 1\nNO 2\nMAYBE 3\n<unk> 4\n")
    (tmp_path / "text").write_text(
        "u1 YES NO\nu2 NO MAYBE YES\n\nu3 MAYBE\n")
    (tmp_path / "oov").write_text("u1 YES NO\nu2 NO PERHAPS\n")
    return str(tmp_path)


@pytest.mark.parametrize("inp,oov", [("text", ""), ("oov", "<unk>"),
                                     ("oov", "NOPE")])
def test_sym2int_and_back(tmp_path, symtab, inp, oov):
    opts = [f"--map-oov={oov}"] if oov else []
    res = both(tmp_path, "sym2int",
               opts + [f"{symtab}/words.txt", f"{symtab}/{inp}", "{out}"])
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 3)
    if oov == "NOPE":       # an OOV symbol the table lacks stays a word
        return
    ints = res["port"][3]
    back = both(tmp_path, "int2sym", [f"{symtab}/words.txt", ints, "{out}"],
                tag="back")
    assert back["port"][0] == back["jax"][0] == 0
    same_files(back, 3)
    with open(back["port"][3]) as f, open(f"{symtab}/{inp}") as g:
        want = [ln.split() for ln in g if ln.split()]
        if oov:
            want = [[w if w != "PERHAPS" else oov for w in ln]
                    for ln in want]
        assert [ln.split() for ln in f] == want


def test_sym2int_raises_on_an_oov(tmp_path, symtab):
    for tools in (ttools.TOOLS, jtools.TOOLS):
        with pytest.raises(Exception, match="OOV symbol PERHAPS"):
            tools["sym2int"]([f"{symtab}/words.txt", f"{symtab}/oov",
                              str(tmp_path / "never")])


def test_sym2int_streams_stdin_to_stdout(tmp_path, symtab, monkeypatch):
    outs = []
    for main in (ttools.main, jtools.main):
        monkeypatch.setattr("sys.stdin", io.StringIO("a YES\nb NO NO\n"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["sym2int", f"{symtab}/words.txt"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == "a 1\nb 2 2\n"


# ---------------------------------------------------------------------------
# copy-vector, vector-sum, wav-copy

@pytest.fixture
def vecs(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(3):
        with TableWriter(f"ark:{tmp_path}/v{i}.ark", holder="vec") as w:
            for k in ("a", "b", "c"):
                w[k] = rng.standard_normal(7).astype(np.float32) * 10 ** i
    with TableWriter(f"ark:{tmp_path}/short.ark", holder="vec") as w:
        w["a"] = np.ones(7, np.float32)
    return str(tmp_path)


@pytest.mark.parametrize("scale", [1.0, -0.25, 3.0])
def test_copy_vector(tmp_path, vecs, scale):
    res = both(tmp_path, "copy-vector",
               [f"--scale={scale}", f"ark:{vecs}/v1.ark", "ark:{out}"])
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 3)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_vector_sum(tmp_path, vecs, n):
    res = both(tmp_path, "vector-sum",
               [f"ark:{vecs}/v{i}.ark" for i in range(n)] + ["ark:{out}"])
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 3)


def test_vector_sum_raises_on_a_missing_key(tmp_path, vecs):
    for tools in (ttools.TOOLS, jtools.TOOLS):
        with pytest.raises(Exception, match="b missing"):
            tools["vector-sum"]([f"ark:{vecs}/v0.ark",
                                 f"ark:{vecs}/short.ark",
                                 f"ark:{tmp_path}/never.ark"])


def test_wav_copy(tmp_path):
    rng = np.random.default_rng(4)
    with TableWriter(f"ark:{tmp_path}/w.ark", holder="wav") as w:
        for i, rate in enumerate((8000, 16000)):
            w[f"u{i}"] = ((3000 * rng.standard_normal(1234 + i))
                          .astype(np.int16), rate)
    res = both(tmp_path, "wav-copy", [f"ark:{tmp_path}/w.ark", "ark:{out}"])
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 3)
    with open(f"{tmp_path}/w.ark", "rb") as f, \
            open(res["port"][3], "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# long-audio segmentation

def long_wave(rng, rate, spans, seconds):
    """Low noise with 300 Hz tones over ``spans`` [(tb, te)] seconds."""
    wave = 20.0 * rng.standard_normal(int(rate * seconds))
    for tb, te in spans:
        t = np.arange(int((te - tb) * rate)) / rate
        f0 = 200 + 100 * rng.random()
        wave[int(tb * rate):int(tb * rate) + len(t)] += \
            8000 * np.sin(2 * np.pi * f0 * t)
    return wave.astype(np.int16)


@pytest.mark.parametrize("opts", [
    (), ("--min-silence-length=0.8",), ("--max-segment-length=2.0",),
    ("--min-segment-length=1.2", "--min-silence-length=0.1")])
def test_segment_long_utterances(tmp_path, opts):
    rng = np.random.default_rng(5)
    with TableWriter(f"ark:{tmp_path}/wav.ark", holder="wav") as w:
        w["recA"] = (long_wave(rng, 8000, [(0.5, 1.4), (1.9, 3.3),
                                           (4.0, 4.3), (5.0, 9.5)], 10),
                     8000)
        w["recB"] = (long_wave(rng, 16000, [(0.2, 2.6), (2.95, 6.0)], 7),
                     16000)
    res = both(tmp_path, "segment-long-utterances",
               [*opts, f"ark:{tmp_path}/wav.ark", "{out}"], port_opts=CPU)
    assert res["port"][0] == res["jax"][0] == 0
    same_files(res, 3)
    with open(res["port"][3]) as f:
        assert len(f.readlines()) >= 2


def vad_mask(rng, T, p_on=0.35, p_off=0.1):
    """A seeded two-state Markov 0/1 mask of T frames."""
    out = np.zeros(T, np.float32)
    on = False
    for t in range(T):
        on = (rng.random() >= p_off) if on else (rng.random() < p_on)
        out[t] = float(on)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_segment_frames_equals_the_original(seed):
    """Merges across gaps shorter than min-silence, splits of runs longer
    than max-segment (at their longest pause, or in half when they have
    none) and drops of short segments, on seeded masks."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(200, 3000))
    vad = vad_mask(rng, T, p_on=float(rng.uniform(0.02, 0.4)),
                   p_off=float(rng.uniform(0.005, 0.2)))
    if seed == 5:
        vad[100:1500] = 1.0        # one run with no pause to split at
    kw = dict(min_silence_length=float(rng.choice([0.05, 0.3, 1.0])),
              min_segment_length=float(rng.choice([0.1, 0.3, 0.8])),
              max_segment_length=float(rng.choice([1.0, 2.5, 10.0])))
    got = tseg.segment_frames(vad, tseg.SegmentationOptions(**kw))
    want = jseg.segment_frames(vad, jseg.SegmentationOptions(**kw))
    assert got == want
    assert got or not vad.any() or kw["min_segment_length"] > 0.1


def test_segment_frames_cases():
    """The shaping rules, by hand: a short gap merges, a short island
    drops, a long run splits at its longest pause."""
    opts = dict(min_silence_length=0.15, min_segment_length=0.3,
                max_segment_length=1.0, segment_padding=0.0)
    vad = np.zeros(300, np.float32)
    vad[10:50] = vad[60:90] = 1     # a 10-frame gap: merged
    vad[120:125] = 1                # 5 frames, gaps of 30 and 25: dropped
    vad[150:195] = vad[205:290] = 1  # 140 frames with a 10-frame pause
    for mod in (tseg, jseg):
        segs = mod.segment_frames(vad, mod.SegmentationOptions(**opts))
        assert segs == [(10, 90), (150, 200), (200, 290)]


@pytest.mark.parametrize("given_feats", [False, True])
def test_segment_long_audio_and_write_segments(tmp_path, given_feats):
    rng = np.random.default_rng(7)
    recos = {}
    for i in range(3):
        spans = sorted(rng.uniform(0, 20, 4).tolist())
        spans = [(spans[j], spans[j] + float(rng.uniform(0.3, 3)))
                 for j in range(4)]
        recos[f"r{i}"] = long_wave(rng, 8000, spans, 25).astype(np.float32)
    out = {}
    for side, mod, extra in (("port", tseg, {"device": "cpu"}),
                             ("jax", jseg, {})):
        r2s = {}
        for k, wave in recos.items():
            feats = None
            if given_feats:
                frames = wave[:len(wave) // 80 * 80].reshape(-1, 80)
                feats = np.log(np.maximum((frames.astype(np.float64) ** 2)
                                          .sum(1), 1e-10))[:, None]
            r2s[k] = mod.segment_long_audio(wave, 8000,
                                            mod.SegmentationOptions(),
                                            feats=feats, **extra)
        path = str(tmp_path / f"segments.{side}")
        mod.write_segments(path, r2s)
        out[side] = (r2s, path)
    assert out["port"][0] == out["jax"][0]
    with open(out["port"][1], "rb") as f, open(out["jax"][1], "rb") as g:
        assert f.read() == g.read()
    assert sum(len(v) for v in out["port"][0].values()) >= 3


def test_segment_long_audio_of_a_short_wave():
    for mod, extra in ((tseg, {"device": "cpu"}), (jseg, {})):
        assert mod.segment_long_audio(np.zeros(100, np.float32), 8000,
                                      **extra) == []


def test_segment_long_audio_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        tseg.segment_long_audio(np.zeros(8000, np.float32), 8000)


def test_the_twelve_tools_are_registered():
    names = {"utt2spk-to-spk2utt", "spk2utt-to-utt2spk",
             "validate-data-dir", "fix-data-dir", "subset-data-dir",
             "split-data", "sym2int", "int2sym", "segment-long-utterances",
             "copy-vector", "vector-sum", "wav-copy"}
    assert len(names) == 12
    assert names <= set(ttools.TOOLS) and names <= set(jtools.TOOLS)
