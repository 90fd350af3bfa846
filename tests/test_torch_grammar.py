"""The port's grammar FSTs (kaldi_tpu_torch/fst/grammar.py, a numpy
copy) against the JAX package's, mirroring tests/test_grammar.py.

Each side builds the base graph, the sub-grammars and the inlined
oracle with its own classes from the same recipe.  Bars: the spliced
CSR arrays equal the JAX package's; the port's BeamDecoder on the
spliced graph equals the JAX BeamDecoder on its spliced graph and the
port's own decode of the inlined graph (alignment and words equal, cost
within 1e-5 relative); a swapped sub-grammar decodes as the original's.
"""

import importlib

import numpy as np
import pytest
import torch

from kaldi_tpu.fst import grammar as jg
from kaldi_tpu_torch.fst import grammar as tg

torch.set_num_threads(1)

NT_CONTACT = 9000
CALL = ("WORD", 10, [1, 2])
NOW = ("WORD", 11, [2, 1])
ALICE = (20, [3, 4])
BOB = (21, [4, 3])
CAROL = (22, [3, 3, 4])
CSR_FIELDS = ("e_offsets", "e_ilabel", "e_olabel", "e_weight",
              "e_nextstate", "n_offsets", "n_olabel", "n_weight",
              "n_nextstate", "final_costs")


class Side:
    """One package's model and graph builders (the original test's
    helpers, over ``pkg``'s classes)."""

    def __init__(self, pkg):
        topology = importlib.import_module(f"{pkg}.am.topology")
        tree = importlib.import_module(f"{pkg}.am.tree")
        transitions = importlib.import_module(f"{pkg}.am.transitions")
        self.fst = importlib.import_module(f"{pkg}.fst.fst")
        self.csr = importlib.import_module(f"{pkg}.fst.csr")
        self.beam = importlib.import_module(f"{pkg}.decoder.beam")
        phones = [1, 2, 3, 4]
        self.topo = topology.HmmTopology.chain(phones)
        self.tree = tree.MonophoneContextDependency(phones, self.topo)
        self.tm = transitions.TransitionModel(self.topo, self.tree)
        self.torch = pkg == "kaldi_tpu_torch"

    def tids(self, phone):
        tm, topo, tree = self.tm, self.topo, self.tree
        st = topo.topology_for_phone(phone)[0]
        fwd = tree.compute([phone], st.forward_pdf_class)
        slf = tree.compute([phone], st.self_loop_pdf_class)
        ts = tm.tuple_to_transition_state(phone, 0, fwd, slf)
        fwd_tid = [tm.pair_to_transition_id(ts, i)
                   for i, (ns, _) in enumerate(st.transitions) if ns != 0][0]
        return fwd_tid, tm.self_loop_of(ts)

    def word_graph(self, words):
        Arc, fst = self.fst.Arc, self.fst.VectorFst()
        loop = fst.add_state()
        fst.set_start(loop)
        fst.set_final(loop, 0.0)
        for wid, phones in words:
            cur = loop
            for i, p in enumerate(phones):
                fwd, slf = self.tids(p)
                nxt = fst.add_state() if i < len(phones) - 1 else loop
                fst.add_arc(cur, Arc(fwd, wid if i == 0 else 0, 0.5, nxt))
                fst.add_arc(nxt, Arc(slf, 0, 0.1, nxt))
                cur = nxt
        return fst

    def linear_graph(self, items):
        Arc, fst = self.fst.Arc, self.fst.VectorFst()
        cur = fst.add_state()
        fst.set_start(cur)
        for item in items:
            if item[0] == "NT":
                nxt = fst.add_state()
                fst.add_arc(cur, Arc(item[1], 0, 0.25, nxt))
                cur = nxt
                continue
            _, wid, phones = item
            for i, p in enumerate(phones):
                fwd, slf = self.tids(p)
                nxt = fst.add_state()
                fst.add_arc(cur, Arc(fwd, wid if i == 0 else 0, 0.5, nxt))
                fst.add_arc(nxt, Arc(slf, 0, 0.1, nxt))
                cur = nxt
        fst.set_final(cur, 0.0)
        return fst

    def inlined(self):
        """The contact loop inlined at the call site, object level."""
        Arc = self.fst.Arc
        inl = self.linear_graph([CALL])
        call_end = max(inl.finals)
        inl.finals.clear()
        loop_off = inl.num_states
        loop = self.word_graph([ALICE, BOB])
        for _ in range(loop.num_states):
            inl.add_state()
        for s in range(loop.num_states):
            for a in loop.arcs[s]:
                inl.add_arc(loop_off + s, Arc(a.ilabel, a.olabel, a.weight,
                                              loop_off + a.nextstate))
        inl.add_arc(call_end, Arc(0, 0, 0.25, loop_off + loop.start))
        tail = self.linear_graph([NOW])
        tail_off = inl.num_states
        for _ in range(tail.num_states):
            inl.add_state()
        for s in range(tail.num_states):
            for a in tail.arcs[s]:
                inl.add_arc(tail_off + s, Arc(a.ilabel, a.olabel, a.weight,
                                              tail_off + a.nextstate))
        for s, w in loop.finals.items():
            inl.add_arc(loop_off + s, Arc(0, 0, w, tail_off + tail.start))
        for s, w in tail.finals.items():
            inl.set_final(tail_off + s, w)
        return self.csr.pack_fst(inl)

    def decode(self, csr, ll):
        kw = {"device": "cpu"} if self.torch else {}
        dec = self.beam.BeamDecoder(
            csr, self.tm.tid_to_pdf_array, self.beam.BeamDecoderConfig(
                beam=1e9, max_active=csr.num_states, acoustic_scale=1.0),
            **kw)
        return dec.decode(ll)


@pytest.fixture(scope="module")
def sides():
    return Side("kaldi_tpu"), Side("kaldi_tpu_torch")


def _spliced(side, mod, words):
    base = side.csr.pack_fst(side.linear_graph([CALL, ("NT", NT_CONTACT),
                                                NOW]))
    sub = side.csr.pack_fst(side.word_graph(words))
    return mod.replace_nonterminals(base, {NT_CONTACT: sub})


def _same_csr(got, want):
    assert (got.num_states, got.start) == (want.num_states, want.start)
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def _same(got, want):
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == pytest.approx(want[2], rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_grammar_matches_jax_and_inlined(sides, seed):
    js, ts = sides
    spliced = _spliced(ts, tg, [ALICE, BOB])
    _same_csr(spliced, _spliced(js, jg, [ALICE, BOB]))
    rng = np.random.default_rng(seed)
    ll = rng.standard_normal((12, ts.tree.num_pdfs)).astype(np.float32)
    got = ts.decode(spliced, ll)
    _same(got, js.decode(_spliced(js, jg, [ALICE, BOB]), ll))
    _same(got, ts.decode(ts.inlined(), ll))


def test_grammar_swap(sides):
    """Swapping the sub-grammar changes what's decodable without
    touching the base graph, as in the original."""
    js, ts = sides

    def score_for(phones):
        pdfs = []
        for fwd, slf in (ts.tids(p) for p in phones):
            pdfs += [ts.tm.transition_id_to_pdf(fwd),
                     ts.tm.transition_id_to_pdf(slf)]
        ll = np.full((len(pdfs), ts.tree.num_pdfs), -8.0, np.float32)
        ll[np.arange(len(pdfs)), pdfs] = 0.0
        return ll

    ll = score_for([1, 2] + list(CAROL[1]) + [2, 1])
    out = {}
    for side, mod in ((ts, tg), (js, jg)):
        pack = side.csr.pack_fst
        base = pack(side.linear_graph([CALL, ("NT", NT_CONTACT), NOW]))
        g = mod.GrammarGraph(base, {NT_CONTACT: pack(
            side.word_graph([ALICE]))})
        first = g.expanded
        dec1 = side.decode(first, ll)
        g.swap_sub(NT_CONTACT, pack(side.word_graph([ALICE, CAROL])))
        assert g.expanded is not first
        out[side.torch] = (first, dec1, g.expanded,
                           side.decode(g.expanded, ll))
    for i in (0, 2):
        _same_csr(out[True][i], out[False][i])
    for i in (1, 3):
        _same(out[True][i], out[False][i])
    assert CAROL[0] not in out[True][1][1]
    assert out[True][3][1] == [10, 22, 11]
    assert out[True][3][2] < out[True][1][2]


def test_no_nonterminal_returns_base(sides):
    _, ts = sides
    base = ts.csr.pack_fst(ts.linear_graph([CALL, NOW]))
    assert tg.replace_nonterminals(base, {NT_CONTACT: base}) is base


def test_sub_without_final_raises(sides):
    from kaldi_tpu_torch.core.logging import KaldiError
    _, ts = sides
    base = ts.csr.pack_fst(ts.linear_graph([CALL, ("NT", NT_CONTACT)]))
    sub = ts.word_graph([ALICE])
    sub.finals.clear()
    with pytest.raises(KaldiError, match="no final state"):
        tg.replace_nonterminals(base, {NT_CONTACT: ts.csr.pack_fst(sub)})
