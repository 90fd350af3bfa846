"""The port's lattice LM rescoring (kaldi_tpu_torch/lattice/rescore.py)
against the JAX package's on the same CompactLattices and ARPA models:
``compose_lm``, ``lmrescore``, ``compose_lm_pruned``, ``lmrescore_pruned``
and ``lmrescore_diff_pruned`` give the same states and arcs, weights
within 1e-5; the pruned difference-LM composition at a wide beam keeps
the exact two-step rescore's paths and costs (as tests/test_flagship.py
holds the JAX one).  Lattices and texts are drawn from numpy seeds; each
side builds its own lattice objects and LMs."""

import numpy as np
import pytest

from kaldi_tpu.fst.arpa import estimate_arpa as j_estimate_arpa
from kaldi_tpu.fst.fst import SymbolTable as JSymbolTable
from kaldi_tpu.lattice import lattice as jlat
from kaldi_tpu.lattice import rescore as jres
from kaldi_tpu_torch.fst.arpa import estimate_arpa as t_estimate_arpa
from kaldi_tpu_torch.fst.fst import SymbolTable as TSymbolTable
from kaldi_tpu_torch.lattice import lattice as tlat
from kaldi_tpu_torch.lattice import rescore as tres

N_WORDS = 10
WORDS = [f"v{i}" for i in range(N_WORDS)]
TOL = 1e-5


def _texts(seed):
    rng = np.random.default_rng(seed)
    return [[WORDS[int(k)] for k in rng.integers(0, N_WORDS,
                                                  int(rng.integers(3, 9)))]
            for _ in range(500)]


def _tables(Tab):
    tab = Tab()
    tab.add("<eps>", 0)
    for w in WORDS:
        tab.add(w)
    return tab


@pytest.fixture(scope="module")
def lms():
    texts = _texts(3)
    out = {}
    for side, est in (("jax", j_estimate_arpa), ("torch", t_estimate_arpa)):
        out[side] = (est(texts, order=2, prune_count=2, vocab=WORDS),
                     est(texts, order=3, prune_count=1, vocab=WORDS))
    return out


def _lattice_spec(seed, n_layers=4, width=3):
    """A random word DAG: layers of states, every state of a layer
    linked to some of the next layer's by word arcs (some ε), with graph
    and acoustic costs and transition-id strings."""
    rng = np.random.default_rng(seed)
    layers = [[0]]
    n = 1
    for _ in range(n_layers):
        k = int(rng.integers(1, width + 1))
        layers.append(list(range(n, n + k)))
        n += k
    arcs = []
    for a, b in zip(layers[:-1], layers[1:]):
        for s in a:
            dsts = rng.choice(b, size=int(rng.integers(1, len(b) + 1)),
                              replace=False)
            for d in dsts:
                for _ in range(int(rng.integers(1, 3))):
                    w = int(rng.integers(0, N_WORDS + 1))
                    if rng.random() < 0.15:
                        w = 0
                    arcs.append((s, w, float(rng.random() * 3),
                                 float(rng.random() * 5),
                                 tuple(int(x) for x in rng.integers(
                                     1, 50, int(rng.integers(1, 4)))),
                                 int(d)))
    finals = {int(s): (float(rng.random()), float(rng.random()), (7,))
              for s in layers[-1]}
    return n, arcs, finals


def _build(mod, spec):
    n, arcs, finals = spec
    c = mod.CompactLattice()
    for _ in range(n):
        c.add_state()
    c.start = 0
    for s, w, gc, ac, tids, d in arcs:
        c.arcs[s].append(mod.CompactArc(w, gc, ac, tids, d))
    c.finals = dict(finals)
    return c


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


def _both(seed):
    spec = _lattice_spec(seed)
    return _build(jlat, spec), _build(tlat, spec)


SEEDS = [0, 1, 2, 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", [1.0, -1.0, 0.5])
def test_compose_lm_matches_jax(lms, seed, scale):
    jc, tc = _both(seed)
    want = jres.compose_lm(jc, lms["jax"][1].score, _tables(JSymbolTable),
                           scale=scale)
    got = tres.compose_lm(tc, lms["torch"][1].score, _tables(TSymbolTable),
                          scale=scale)
    _same_lattice(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_lmrescore_matches_jax(lms, seed):
    jc, tc = _both(seed)
    want = jres.lmrescore(jc, *lms["jax"], _tables(JSymbolTable),
                          lm_scale=1.0)
    got = tres.lmrescore(tc, *lms["torch"], _tables(TSymbolTable),
                         lm_scale=1.0)
    _same_lattice(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("beam", [2.0, 6.0])
def test_compose_lm_pruned_matches_jax(lms, seed, beam):
    jc, tc = _both(seed)
    want = jres.compose_lm_pruned(jc, lms["jax"][1].score,
                                  _tables(JSymbolTable), beam=beam)
    got = tres.compose_lm_pruned(tc, lms["torch"][1].score,
                                 _tables(TSymbolTable), beam=beam)
    _same_lattice(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_lmrescore_pruned_matches_jax(lms, seed):
    jc, tc = _both(seed)
    want = jres.lmrescore_pruned(jc, *lms["jax"], _tables(JSymbolTable),
                                 beam=4.0, max_arcs=60)
    got = tres.lmrescore_pruned(tc, *lms["torch"], _tables(TSymbolTable),
                                beam=4.0, max_arcs=60)
    _same_lattice(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("beam", [3.0, 8.0])
def test_lmrescore_diff_pruned_matches_jax(lms, seed, beam):
    jc, tc = _both(seed)
    want = jres.lmrescore_diff_pruned(jc, *lms["jax"], _tables(JSymbolTable),
                                      lm_scale=1.0, beam=beam)
    got = tres.lmrescore_diff_pruned(tc, *lms["torch"],
                                     _tables(TSymbolTable), lm_scale=1.0,
                                     beam=beam)
    _same_lattice(got, want)


def _paths(cl):
    """Word sequence → best total cost over the lattice's paths."""
    out = {}

    def go(s, ws, cost):
        if s in cl.finals:
            gc, ac, _ = cl.finals[s]
            k = tuple(ws)
            out[k] = min(out.get(k, np.inf), cost + gc + ac)
        for a in cl.arcs[s]:
            go(a.nextstate, ws + ([a.word] if a.word else []),
               cost + a.graph_cost + a.acoustic_cost)
    go(cl.start, [], 0.0)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_diff_pruned_keeps_the_exact_rescore(lms, seed):
    """At a wide beam the one-pass difference-LM composition has the
    exact two-step rescore's paths and path costs."""
    _, tc = _both(seed)
    tab = _tables(TSymbolTable)
    exact = tres.lmrescore(tc, *lms["torch"], tab)
    fast = tres.lmrescore_diff_pruned(tc, *lms["torch"], tab, beam=100.0)
    pe, pf = _paths(exact), _paths(fast)
    assert set(pe) == set(pf)
    for k in pe:
        assert pf[k] == pytest.approx(pe[k], abs=1e-6)


def test_lattice_package_exports_rescoring():
    import kaldi_tpu.lattice as jl
    import kaldi_tpu_torch.lattice as tl
    for name in ("compose_lm", "lmrescore", "compose_lm_pruned",
                 "lmrescore_pruned"):
        assert name in tl.__all__ and name in jl.__all__
        assert getattr(tl, name) is getattr(tres, name)
