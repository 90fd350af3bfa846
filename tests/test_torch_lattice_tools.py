"""The port's lattice and LM tools against the JAX package's on the same
arks (``python -m kaldi_tpu_torch.cli <tool>``, called in process here):
lattice-lmrescore, lattice-lmrescore-const-arpa, lattice-lmrescore-pruned,
lattice-oracle, lattice-depth, lattice-best-path, lattice-scale,
lattice-prune, lattice-add-penalty, lattice-1best and lattice-mbr-decode.
The input lattices are decoded by the port (CPU) on a seeded 300-word
task at a noise that leaves 2-32 word paths in each; the LMs and
words.txt are files the port writes.  Lattice outputs equal the JAX
tool's (states, arcs, tids; weights within 1e-5), text outputs are
equal strings."""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import TOOLS as JTOOLS
from kaldi_tpu_torch.cli import TOOLS as TTOOLS
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
from kaldi_tpu_torch.fst.arpa import estimate_arpa, write_arpa
from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(dir, lattices rspec, words.txt, trigram.arpa, 4-gram.arpa, refs
    rspec, {utt: CompactLattice})."""
    d = tmp_path_factory.mktemp("lattice_tools")
    task = tlv.make_largevocab_task(vocab_size=300, order=3, seed=7,
                                    closure=False, corpus_sentences=600)
    ev = tlv.sample_eval_set(task, 5, max_words=6, seed=21)
    rng = np.random.default_rng(5)
    lls = [tlv.synth_loglikes(task, ev[u], rng, noise=1.2, peak=2.5)
           for u in sorted(ev)]
    lens = np.array([len(x) for x in lls], np.int64)
    X = np.zeros((len(lls), int(lens.max()), task.num_pdfs), np.float32)
    for b, x in enumerate(lls):
        X[b, :len(x)] = x
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                      BeamDecoderConfig(beam=13.0, max_active=2000,
                                        acoustic_scale=1.0,
                                        lattice_beam=7.0,
                                        lattice_arcs_per_frame=2048),
                      device="cpu")
    lats = dict(zip(sorted(ev), dec.decode_compact_batch(X, lens)))
    # lattices with alternatives: 2-32 word paths each
    assert sum(len(lat.paths()) for lat in lats.values()) > 50
    lat_path = str(d / "lat.ark")
    with TableWriter(f"ark:{lat_path}", holder="clat") as w:
        for u, lat in lats.items():
            w[u] = lat
    ref_path = str(d / "ref.txt")
    with TableWriter(f"ark,t:{ref_path}", holder="text") as w:
        for u in sorted(ev):
            w[u] = ev[u]
    words = str(d / "words.txt")
    task.words.write(words)
    arpa3, arpa4 = str(d / "lm3.arpa"), str(d / "lm4.arpa")
    write_arpa(task.arpa, arpa3)
    write_arpa(estimate_arpa(task.texts, order=4, prune_count=1,
                             vocab=[w for w, _ in task.entries]), arpa4)
    return d, f"ark:{lat_path}", words, arpa3, arpa4, f"ark:{ref_path}", lats


def _read_lats(path):
    return dict(SequentialTableReader(f"ark:{path}", holder="clat"))


def _same_lattice(got, want):
    assert got.start == want.start
    assert got.num_states == want.num_states
    assert sorted(got.finals) == sorted(want.finals)
    for s, (gc, ac, tids) in want.finals.items():
        g = got.finals[s]
        assert tuple(g[2]) == tuple(tids)
        assert g[0] == pytest.approx(gc, abs=TOL)
        assert g[1] == pytest.approx(ac, abs=TOL)
    for s in range(want.num_states):
        assert len(got.arcs[s]) == len(want.arcs[s])
        for a, b in zip(got.arcs[s], want.arcs[s]):
            assert (a.word, a.nextstate, tuple(a.tids)) == \
                (b.word, b.nextstate, tuple(b.tids))
            assert a.graph_cost == pytest.approx(b.graph_cost, abs=TOL)
            assert a.acoustic_cost == pytest.approx(b.acoustic_cost,
                                                    abs=TOL)


def _run_both(name, argv_of, tmp, out_name):
    """Run tool ``name`` of each package; ``argv_of(out)`` builds its
    arguments for output file ``out`` → (port's output, JAX's)."""
    outs = []
    for side, tools in (("torch", TTOOLS), ("jax", JTOOLS)):
        out = os.path.join(str(tmp), f"{side}_{out_name}")
        assert tools[name](argv_of(out)) in (0, None)
        outs.append(out)
    return outs


# (tool, options, LM arguments before the lattice rspec)
LATTICE_TOOLS = [
    ("lattice-lmrescore", ["--lm-scale=0.8"], ("arpa3", "arpa4", "words")),
    ("lattice-lmrescore-const-arpa", ["--lm-scale=-1.0"],
     ("arpa3", "words")),
    ("lattice-lmrescore-pruned", ["--lattice-compose-beam=4.0"],
     ("arpa3", "arpa4", "words")),
    ("lattice-scale", ["--lm-scale=0.5", "--acoustic-scale=2.0"], ()),
    ("lattice-prune", ["--beam=2.0"], ()),
    ("lattice-add-penalty", ["--word-ins-penalty=0.7"], ()),
    ("lattice-1best", ["--acoustic-scale=0.5"], ()),
]


@pytest.mark.parametrize("name,opts,lm_args", LATTICE_TOOLS,
                         ids=[t[0] for t in LATTICE_TOOLS])
def test_lattice_tool_matches_jax(files, name, opts, lm_args):
    d, lat, words, arpa3, arpa4, _, lats = files
    paths = {"arpa3": arpa3, "arpa4": arpa4, "words": words}
    got, want = _run_both(
        name, lambda out: opts + [paths[a] for a in lm_args]
        + [lat, f"ark:{out}"], d, f"{name}.ark")
    g, w = _read_lats(got), _read_lats(want)
    assert sorted(g) == sorted(w) == sorted(lats)
    for u in w:
        _same_lattice(g[u], w[u])


def _text(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("opts", [["--lm-scale=1.0"],
                                  ["--lm-scale=2.0", "--acoustic-scale=0.5"]])
def test_lattice_best_path_matches_jax(files, opts):
    d, lat, words, *_ = files
    got, want = _run_both(
        "lattice-best-path",
        lambda out: opts + [f"--word-symbol-table={words}", lat,
                            f"ark,t:{out}"], d, f"best{len(opts)}.txt")
    assert _text(got) == _text(want) != ""


def test_lattice_mbr_decode_matches_jax(files):
    d, lat, words, *_ = files
    got, want = _run_both(
        "lattice-mbr-decode",
        lambda out: [f"--word-symbol-table={words}", lat, f"ark,t:{out}"],
        d, "mbr.txt")
    assert _text(got) == _text(want) != ""


def test_lattice_depth_matches_jax(files, capsys):
    d, lat, *_ = files
    got, want = _run_both("lattice-depth",
                          lambda out: [lat, f"ark,t:{out}"], d, "depth.txt")
    assert _text(got) == _text(want) != ""
    # without an output the depths go to stdout
    outs = []
    for tools in (TTOOLS, JTOOLS):
        assert tools["lattice-depth"]([lat]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] != ""


def test_lattice_oracle_matches_jax(files, capsys):
    d, lat, words, _, _, ref, _ = files
    prints = []

    def argv(out):
        return [f"--word-symbol-table={words}", lat, ref, f"ark,t:{out}"]
    for name, tools in (("torch", TTOOLS), ("jax", JTOOLS)):
        assert tools["lattice-oracle"](argv(
            os.path.join(str(d), f"{name}_oracle.txt"))) == 0
        prints.append(capsys.readouterr().out)
    assert prints[0] == prints[1]
    assert prints[0].startswith("%WER ")
    assert _text(os.path.join(str(d), "torch_oracle.txt")) == \
        _text(os.path.join(str(d), "jax_oracle.txt")) != ""


def test_tools_chain_through_processes(files, tmp_path):
    """lattice-scale → lattice-add-penalty → lattice-lmrescore-pruned →
    lattice-best-path as processes of ``python -m kaldi_tpu_torch.cli``
    equals the same steps in process."""
    import subprocess
    import sys
    d, lat, words, arpa3, arpa4, _, _ = files
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def cli(*args):
        subprocess.run([sys.executable, "-m", "kaldi_tpu_torch.cli", *args],
                       cwd=root, check=True, capture_output=True,
                       timeout=120)
    a, b, c = (str(tmp_path / f"{x}.ark") for x in "abc")
    cli("lattice-scale", "--lm-scale=0.9", lat, f"ark:{a}")
    cli("lattice-add-penalty", "--word-ins-penalty=0.2", f"ark:{a}",
        f"ark:{b}")
    cli("lattice-lmrescore-pruned", arpa3, arpa4, words, f"ark:{b}",
        f"ark:{c}")
    cli("lattice-best-path", f"--word-symbol-table={words}", f"ark:{c}",
        f"ark,t:{tmp_path / 'best.txt'}")
    steps = [("lattice-scale", ["--lm-scale=0.9", lat, "ark:{o}"]),
             ("lattice-add-penalty", ["--word-ins-penalty=0.2", "ark:{i}",
                                      "ark:{o}"]),
             ("lattice-lmrescore-pruned", [arpa3, arpa4, words, "ark:{i}",
                                           "ark:{o}"]),
             ("lattice-best-path", [f"--word-symbol-table={words}",
                                    "ark:{i}", "ark,t:{o}"])]
    prev = None
    for k, (name, argv) in enumerate(steps):
        out = str(tmp_path / f"in_{k}")
        assert TTOOLS[name]([x.format(i=prev, o=out) for x in argv]) == 0
        prev = out
    assert _text(prev) == _text(tmp_path / "best.txt") != ""
