"""Utterance-initial states of the left-biphone den graph (am/chain.py
``make_denominator_graph``).

The numerator gives an utterance's first phone the window (0, p), no
left context (pipelines/chain.py ``make_chain_egs``); the original's den
states all have a real left phone.  Where the tree gives (0, p) a pdf of
its own, no state of the original's graph emits it, so LF-MMI trains it
on the numerator alone and raising its score raises the objective
without bound.  The port's builder gives each phone that starts a
training sequence and has such a window a start state, which the den
then follows; where the tree reads every such window, the graph is the
original's, array for array.
"""

import dataclasses

import numpy as np
import pytest
import torch

import kaldi_tpu.am.chain as jchain
import kaldi_tpu.am.topology as jtopo
import kaldi_tpu.am.tree as jtree
from kaldi_tpu_torch.am import chain
from kaldi_tpu_torch.am import tree as ttree
from kaldi_tpu_torch.am.topology import HmmTopology

torch.set_num_threads(1)

PHONES = [1, 2, 3, 4]
GRAPH_FIELDS = ("src", "dst", "pdf", "logw", "initial", "final", "l_self",
                "l_fwd", "state_self_pdf", "state_entry_pdf", "lm_initial",
                "lm_l_self", "lm_l_fwd", "lm_final")


def _seqs(firsts=None):
    """30 seeded phone sequences; ``firsts`` restricts their first
    phones."""
    rng = np.random.default_rng(3)
    seqs = [list(rng.choice(PHONES, size=int(rng.integers(3, 8))))
            for _ in range(30)]
    if firsts is not None:
        for i, s in enumerate(seqs):
            s[0] = firsts[i % len(firsts)]
    return seqs


def _pair(seqs, tree="full"):
    """(port topology, port tree, port den, JAX den) of a "full"
    left-biphone tree, a "left-blind" one (``_LeftBlind``) or a
    "monophone" tree."""
    out = []
    for topo_cls, tree_mod, mod in ((HmmTopology, ttree, chain),
                                    (jtopo.HmmTopology, jtree, jchain)):
        topo = topo_cls.chain(PHONES)
        t = {"full": lambda: tree_mod.full_biphone_tree(PHONES, topo),
             "left-blind": lambda: _LeftBlind(),
             "monophone": lambda: tree_mod.MonophoneContextDependency(
                 PHONES, topo)}[tree]()
        out.append((topo, t, mod.make_denominator_graph(seqs, t, topo,
                                                        order=2)))
    (topo, t, den), (_, _, jden) = out
    return topo, t, den, jden


def port_graph(jden) -> chain.DenominatorGraph:
    """The JAX package's den graph as the port's: the original's graph,
    with no utterance-initial states."""
    kw = {f.name: getattr(jden, f.name)
          for f in dataclasses.fields(chain.DenominatorGraph)}
    kw = {k: np.array(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    kw["lm"] = chain.PhoneLm(**{f.name: getattr(jden.lm, f.name)
                                for f in dataclasses.fields(chain.PhoneLm)})
    return chain.DenominatorGraph(**kw)


def _starts(den):
    """{den state: phone index} of the utterance-initial states."""
    return {s: g for (g, li), s in den.exp_index.items() if li < 0}


def _read(den, states):
    return set(np.asarray(den.state_self_pdf)[states].tolist()) \
        | set(np.asarray(den.state_entry_pdf)[states].tolist())


@pytest.mark.parametrize("firsts", [None, [2], [1, 3]],
                         ids=["any", "one", "two"])
def test_start_states_cover_the_unread_utterance_initial_windows(firsts):
    """A full biphone tree gives every (0, p) window its own pdfs, which
    no state of the original's graph emits: the port's graph has a start
    state for each phone that begins a sequence (and for no other), whose
    pdfs are those windows'.  The start states hold the reference's
    initial mass: a state that nothing enters with p_self 1/2, started
    with probability q, averages q·(1 − 2^-100)/50 over 100 frames."""
    seqs = _seqs(firsts)
    topo, tree, den, jden = _pair(seqs)
    main = jden.num_states
    starts = _starts(den)
    assert sorted(starts) == list(range(main, den.num_states))
    first = sorted({int(s[0]) for s in seqs})
    assert sorted(den.lm.hists[g][0] + 1 for g in starts.values()) == first
    orig = _read(den, np.arange(main))
    for p in PHONES:
        win = {tree.compute([0, p], 0), tree.compute([0, p], 1)}
        assert not win & orig
        assert win <= _read(den, np.arange(den.num_states)) \
            or p not in first
    p0 = np.exp(den.initial.astype(np.float64))
    assert abs(p0.sum() - 1.0) < 1e-5
    want = (1.0 - 0.5 ** chain.INITIAL_FRAMES) / (
        chain.INITIAL_FRAMES * 0.5)
    assert abs(p0[main:].sum() - want) < 1e-6
    # nothing enters a start state but its own self-loop
    into = den.dst[den.src != den.dst]
    assert not np.isin(into, list(starts)).any()


def assert_original_within(den, jden) -> None:
    """The port's left-biphone graph ``den``, left out its start states
    (the last ones) and their arcs, is the original's ``jden``; the
    original's initial mass is scaled by one less the start states'
    share."""
    main = jden.num_states
    keep = den.src < main
    for name in ("src", "dst", "pdf", "logw"):
        np.testing.assert_array_equal(getattr(den, name)[keep],
                                      np.asarray(getattr(jden, name)),
                                      err_msg=name)
    for name in ("final", "l_self", "l_fwd", "state_self_pdf",
                 "state_entry_pdf"):
        np.testing.assert_array_equal(getattr(den, name)[:main],
                                      np.asarray(getattr(jden, name)),
                                      err_msg=name)
    p0 = np.exp(den.initial.astype(np.float64))
    np.testing.assert_allclose(
        p0[:main], (1.0 - p0[main:].sum())
        * np.exp(np.asarray(jden.initial, np.float64)), rtol=1e-5)
    assert {k: v for k, v in den.exp_index.items() if v < main} \
        == jden.exp_index
    assert den.lm.hists == jden.lm.hists
    np.testing.assert_array_equal(den.lm.next_state, jden.lm.next_state)


def test_main_states_are_the_jax_graph():
    _, _, den, jden = _pair(_seqs())
    assert den.num_states > jden.num_states
    assert_original_within(den, jden)


class _LeftBlind:
    """A left-biphone tree whose pdfs ignore the left phone: every
    window (0, p) shares the pdfs of (l, p)."""
    context_width, central_position = 2, 1
    num_pdfs = 2 * (max(PHONES) + 1)

    def compute(self, window, cls):
        return 2 * window[1] + cls


@pytest.mark.parametrize("tree", ["left-blind", "monophone"])
def test_no_start_states_where_the_tree_reads_every_start_window(tree):
    """A tree that gives (0, p) the pdfs of some (l, p), and a monophone
    tree, get the original's graph, array for array."""
    _, _, den, jden = _pair(_seqs(), tree)
    assert den.num_states == jden.num_states
    for name in GRAPH_FIELDS:
        a, b = getattr(jden, name), getattr(den, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
    assert den.exp_index == jden.exp_index


@pytest.mark.parametrize("graph", ["original", "start-states"])
def test_objective_bounded_only_with_start_states(graph):
    """A numerator path whose frame 0 is phone 1's utterance-initial
    entry pdf, that pdf's score raised by 40 and then by 80: num − den
    rises by the further 40 on the original's graph (the den never sees
    the pdf), and not at all on the port's (the den's start state follows
    it)."""
    seqs = _seqs([1, 2])
    _, tree, den, jden = _pair(seqs)
    if graph == "original":
        den = port_graph(jden)
    P = tree.num_pdfs
    rng = np.random.default_rng(5)
    T = 12
    base = torch.from_numpy(rng.standard_normal((1, T, P))
                            .astype(np.float32))
    ali = torch.tensor([[tree.compute([0, 1], 0)]
                        + [tree.compute([0, 1], 1)] * (T - 1)])
    mask = torch.ones((1, T), dtype=torch.bool)
    gains = []
    for boost in (40.0, 80.0):
        scores = base.clone()
        scores[0, 0, ali[0, 0]] += boost
        num = chain.numerator_logprob(scores, ali, mask)
        den_lp = chain.denominator_logprob(den, scores, mask, 0.1)
        gains.append(float(num - den_lp))
    rise = gains[1] - gains[0]
    if graph == "start-states":
        assert abs(rise) < 1e-3, rise
    else:
        assert abs(rise - 40.0) < 1e-3, rise
