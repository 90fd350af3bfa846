"""The port's copies of the lattice host modules (lattice/ops.py,
word_align.py, phone_align.py, ctm.py) and their 16 tools against the
JAX package's, on the CPU.

The lattices are decoded by the port on a seeded 300-word task (SIL is
phone 1) at a noise that leaves several word paths in each; a second
set is the same lattices pruned to beam 2.  Each package reads the same
arks, model (a flat GMM on the task's transition model, written by the
port), lexicons and words.txt.  The modules are the original's numpy,
so every lattice, CTM, alignment and text they give equals the
original's exactly (states, arcs, tids and weights).  The tools are run
in process through each package's registry (``TOOLS``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import kaldi_tpu.lattice.ctm as jctm
import kaldi_tpu.lattice.ops as jops
import kaldi_tpu.lattice.phone_align as jpa
import kaldi_tpu.lattice.word_align as jwa
import kaldi_tpu_torch.lattice.ctm as tctm
import kaldi_tpu_torch.lattice.ops as tops
import kaldi_tpu_torch.lattice.phone_align as tpa
import kaldi_tpu_torch.lattice.word_align as twa
from kaldi_tpu.am.serialize import read_mdl as j_read_mdl
from kaldi_tpu.cli import TOOLS as JTOOLS
from kaldi_tpu.core.table import SequentialTableReader as JReader
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
from kaldi_tpu_torch.cli import TOOLS as TTOOLS
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
from kaldi_tpu_torch.lattice import prune_lattice
from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)

SIL = {1}
LATTICE_TOOLS_16 = [
    "lattice-to-ctm", "lattice-union", "lattice-interp", "lattice-push",
    "lattice-to-phone-lattice", "lattice-confidence", "lattice-equivalent",
    "lattice-align-phones", "lattice-boost-ali", "lattice-minimize",
    "lattice-combine", "lattice-difference", "nbest-to-lattice",
    "nbest-to-prons", "lattice-align-words-lexicon", "lattice-align-words"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Paths of the shared inputs, and the task."""
    d = tmp_path_factory.mktemp("lattice_ops")
    task = tlv.make_largevocab_task(vocab_size=300, order=3, seed=7,
                                    closure=False, corpus_sentences=600)
    ev = tlv.sample_eval_set(task, 4, max_words=6, seed=21)
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
    assert sum(len(lat.paths()) for lat in lats.values()) > 20
    p = {k: str(d / k) for k in ("lat", "pruned", "nbest", "ali", "mdl",
                                 "words", "phones", "lexicon", "lexint",
                                 "alilex")}
    with TableWriter(f"ark:{p['lat']}", holder="clat") as w:
        for u, lat in lats.items():
            w[u] = lat
    with TableWriter(f"ark:{p['pruned']}", holder="clat") as w:
        for u, lat in lats.items():
            w[u] = prune_lattice(lat, 2.0)
    # single-path lattices keyed utt-1, utt-2: each lattice's best path
    # and its second path
    with TableWriter(f"ark:{p['nbest']}", holder="clat") as w:
        for u, lat in lats.items():
            for i, path in enumerate(_nbest_lattices(lat, 2), start=1):
                w[f"{u}-{i}"] = path
    with TableWriter(f"ark:{p['ali']}", holder="ivec") as w:
        for u, lat in lats.items():
            w[u] = np.asarray(lat.best_path()[1], np.int32)
    am = AmDiagGmm.flat_start(task.num_pdfs, np.zeros(3), np.ones(3),
                              device="cpu")
    write_mdl(p["mdl"], task.tm, am)
    task.words.write(p["words"])
    task.phones.write(p["phones"])
    with open(p["lexicon"], "w") as f:
        for w, phones in task.entries:
            f.write(f"{w} {' '.join(phones)}\n")
    with open(p["lexint"], "w") as f, open(p["alilex"], "w") as g:
        g.write("0 0 1\n")
        for w, phones in task.entries:
            ids = " ".join(str(task.phones[x]) for x in phones)
            f.write(f"{task.words[w]} {ids}\n")
            g.write(f"{task.words[w]} {task.words[w]} {ids}\n")
    return p, task


def _nbest_lattices(lat, n):
    """The n best paths of ``lat`` as single-path lattices (port)."""
    from kaldi_tpu_torch.lattice import CompactArc, CompactLattice
    out = []
    paths = []

    def walk(s, arcs, cost):
        if s in lat.finals:
            gc, ac, tids = lat.finals[s]
            paths.append((cost + gc + ac, arcs, lat.finals[s]))
        for a in lat.arcs[s]:
            walk(a.nextstate, arcs + [a], cost + a.total)

    walk(lat.start, [], 0.0)
    for _, arcs, fin in sorted(paths, key=lambda x: x[0])[:n]:
        c = CompactLattice()
        cur = c.add_state()
        c.start = cur
        for a in arcs:
            nxt = c.add_state()
            c.arcs[cur].append(CompactArc(a.word, a.graph_cost,
                                          a.acoustic_cost, a.tids, nxt))
            cur = nxt
        c.finals[cur] = fin
        out.append(c)
    return out


def _both(files, key):
    """The ark at ``key`` read by the port's reader and by JAX's."""
    p, _ = files
    return (dict(SequentialTableReader(f"ark:{p[key]}", holder="clat")),
            dict(JReader(f"ark:{p[key]}", holder="clat")))


def same_lattice(got, want):
    """Equal compact lattices: start, states, finals, arcs (word, next
    state, tids, weights) in order."""
    assert got.start == want.start
    assert got.num_states == want.num_states
    assert sorted(got.finals) == sorted(want.finals)
    for s, fin in want.finals.items():
        g = got.finals[s]
        assert (g[0], g[1], tuple(g[2])) == (fin[0], fin[1], tuple(fin[2]))
    for s in range(want.num_states):
        assert [(a.word, a.graph_cost, a.acoustic_cost, tuple(a.tids),
                 a.nextstate) for a in got.arcs[s]] == \
            [(a.word, a.graph_cost, a.acoustic_cost, tuple(a.tids),
              a.nextstate) for a in want.arcs[s]]


# -- the modules ------------------------------------------------------------

def test_modules_name_their_originals():
    for mod in (tops, twa, tpa, tctm):
        path = mod.__file__
        with open(path) as f:
            first = f.readline()
        name = os.path.basename(path)
        assert f"kaldi_tpu/lattice/{name}" in first


@pytest.mark.parametrize("fn", ["lattice_union", "interp_lattices"])
def test_two_lattice_ops_match(files, fn):
    (t_full, j_full), (t_pr, j_pr) = _both(files, "lat"), _both(files,
                                                                "pruned")
    for u in sorted(t_full):
        args_t = (t_full[u], t_pr[u]) + ((0.3,) if fn != "lattice_union"
                                         else ())
        args_j = (j_full[u], j_pr[u]) + args_t[2:]
        got, want = getattr(tops, fn)(*args_t), getattr(jops, fn)(*args_j)
        if want is None:
            assert got is None
        else:
            same_lattice(got, want)


def test_one_lattice_ops_match(files):
    _, task = files
    tm_t = read_mdl(files[0]["mdl"], device="cpu")[0]
    tm_j = j_read_mdl(files[0]["mdl"])[0]
    t_l, j_l = _both(files, "lat")
    t_p, j_p = _both(files, "pruned")
    for u in sorted(t_l):
        same_lattice(tops.push_lattice(t_l[u]), jops.push_lattice(j_l[u]))
        same_lattice(tops.lattice_to_phone_lattice(t_l[u], tm_t),
                     jops.lattice_to_phone_lattice(j_l[u], tm_j))
        assert tops.enumerate_paths(t_l[u]) == jops.enumerate_paths(j_l[u])
        assert tops.lattice_confidence(t_l[u]) == \
            jops.lattice_confidence(j_l[u])
        for a, b in ((t_l, j_l), (t_p, j_p)):
            assert tops.lattices_equivalent(t_l[u], a[u]) == \
                jops.lattices_equivalent(j_l[u], b[u])
        same_lattice(tpa.minimize_lattice(t_l[u]),
                     jpa.minimize_lattice(j_l[u]))
        for rep in (True, False):
            same_lattice(
                tpa.phone_align_lattice(t_l[u], tm_t,
                                        replace_output_symbols=rep),
                jpa.phone_align_lattice(j_l[u], tm_j,
                                        replace_output_symbols=rep))
        ali = list(t_l[u].best_path()[1])
        same_lattice(tpa.boost_lattice_ali(t_l[u], tm_t, ali, 0.1,
                                           silence_phones=SIL,
                                           max_silence_error=0.5),
                     jpa.boost_lattice_ali(j_l[u], tm_j, ali, 0.1,
                                           silence_phones=SIL,
                                           max_silence_error=0.5))


def _prons(task):
    return {task.words[w]: [[task.phones[x] for x in phones]]
            for w, phones in task.entries}


def test_word_alignment_and_ctm_match(files):
    p, task = files
    tm_t = read_mdl(p["mdl"], device="cpu")[0]
    tm_j = j_read_mdl(p["mdl"])[0]
    t_l, j_l = _both(files, "lat")
    prons = _prons(task)
    n_ok = 0
    for u in sorted(t_l):
        (ga, gok), (wa, wok) = (twa.word_align_lattice(t_l[u], tm_t, prons,
                                                       SIL),
                                jwa.word_align_lattice(j_l[u], tm_j, prons,
                                                       SIL))
        assert gok == wok
        n_ok += gok
        same_lattice(ga, wa)
        assert twa.lattice_word_times(ga) == jwa.lattice_word_times(wa)
        tids = list(t_l[u].best_path()[1])
        assert tctm.phone_runs(tm_t, tids) == jctm.phone_runs(tm_j, tids)
        for pr in (None, prons):
            got = tctm.best_path_ctm(t_l[u], tm_t, task.words, u, SIL, 0.03,
                                     prons=pr)
            want = jctm.best_path_ctm(j_l[u], tm_j, task.words, u, SIL,
                                      0.03, prons=pr)
            assert [dataclasses.astuple(e) for e in got] == \
                [dataclasses.astuple(e) for e in want] and got
    assert n_ok > 0


# -- the 16 tools -------------------------------------------------------------

def test_the_port_registers_the_16_tools():
    for name in LATTICE_TOOLS_16:
        assert name in TTOOLS and name in JTOOLS


def _run(name, argv_of, tmp, out_name):
    """Each package's tool ``name`` on ``argv_of(out)`` → (outputs, exit
    codes), the port's first."""
    outs, rcs = [], []
    for side, tools in (("torch", TTOOLS), ("jax", JTOOLS)):
        out = os.path.join(str(tmp), f"{side}_{out_name}")
        rcs.append(tools[name](argv_of(out)) or 0)
        outs.append(out)
    return outs, rcs


def _lattices(path):
    return dict(SequentialTableReader(f"ark:{path}", holder="clat"))


def _text(path):
    with open(path) as f:
        return f.read()


# (tool, arguments before the output; names in braces are input files;
# what the output is)
TOOL_CASES = [
    ("lattice-union", ["ark:{lat}", "ark:{pruned}"], "clat"),
    ("lattice-interp", ["--alpha=0.3", "ark:{lat}", "ark:{pruned}"], "clat"),
    ("lattice-push", ["ark:{lat}"], "clat"),
    ("lattice-to-phone-lattice", ["{mdl}", "ark:{lat}"], "clat"),
    ("lattice-confidence", ["ark:{lat}"], "text"),
    ("lattice-align-phones", ["{mdl}", "ark:{lat}"], "clat"),
    ("lattice-align-phones", ["--replace-output-symbols=false", "{mdl}",
                              "ark:{lat}"], "clat"),
    ("lattice-boost-ali", ["--b=0.1", "--silence-phones=1",
                           "--max-silence=0.5", "{mdl}", "ark:{lat}",
                           "ark:{ali}"], "clat"),
    ("lattice-minimize", ["ark:{lat}"], "clat"),
    ("lattice-combine", ["--lat-weights=0.3:0.7", "ark:{lat}",
                         "ark:{pruned}"], "clat"),
    ("lattice-combine", ["ark:{pruned}", "ark:{lat}"], "clat"),
    ("lattice-difference", ["ark:{lat}", "ark:{pruned}"], "clat"),
    ("nbest-to-lattice", ["ark:{nbest}"], "clat"),
    ("nbest-to-prons", ["{mdl}", "{lexint}", "ark:{nbest}"], "text"),
    ("lattice-align-words-lexicon", ["{alilex}", "{mdl}", "ark:{lat}"],
     "clat"),
    ("lattice-align-words-lexicon", ["--silence-phones=1", "{alilex}",
                                     "{mdl}", "ark:{pruned}"], "clat"),
    ("lattice-align-words", ["{lexicon}", "{phones}", "{words}", "{mdl}",
                             "ark:{lat}"], "clat"),
]


@pytest.mark.parametrize("name,args,kind", TOOL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(TOOL_CASES)])
def test_tool_matches_jax(files, tmp_path, name, args, kind):
    p, _ = files
    argv = [a.format(**p) for a in args]
    spec = "ark,t:{}" if kind == "text" else "ark:{}"
    (got, want), rcs = _run(name, lambda out: argv + [spec.format(out)],
                            tmp_path, "out")
    assert rcs == [0, 0]
    if kind == "text":
        assert _text(got) == _text(want)
        assert _text(got).strip()
    else:
        g, w = _lattices(got), _lattices(want)
        assert sorted(g) == sorted(w) and g
        for u in w:
            same_lattice(g[u], w[u])


@pytest.mark.parametrize("second,rc", [("lat", 0), ("pruned", 1)])
def test_lattice_equivalent_exit_code_matches_jax(files, second, rc):
    p, _ = files
    argv = [f"ark:{p['lat']}", f"ark:{p[second]}"]
    assert TTOOLS["lattice-equivalent"](argv) == \
        JTOOLS["lattice-equivalent"](argv) == rc


@pytest.mark.parametrize("opts", [[], ["--lexicon={lexicon}",
                                       "--phone-symbol-table={phones}",
                                       "--frame-shift=0.03"]],
                         ids=["phones", "lexicon"])
def test_lattice_to_ctm_matches_jax(files, tmp_path, opts):
    p, _ = files
    argv = [o.format(**p) for o in opts] + [p["mdl"], p["words"],
                                            f"ark:{p['lat']}"]
    (got, want), rcs = _run("lattice-to-ctm", lambda out: argv + [out],
                            tmp_path, "ctm")
    assert rcs == [0, 0]
    assert _text(got) == _text(want) and _text(got).strip()
