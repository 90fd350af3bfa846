"""Context-dependent graphs in the PyTorch port: tests/test_biglang_cd.py
held on the port and against the JAX package.

The port's generic triphone mkgraph (compose_context + H + determinize +
minimize + self-loops, ported in this slice) is the oracle of its direct
context-dependent biglang construction, as the original's is: both
graphs accept the same (tids, words) sequences at the same least cost,
and each equals the JAX package's graph from the same seeded tree.
``make_largevocab_task(context="biphone")`` (restored in this slice)
builds the JAX package's task, graph and synthetic alignments from the
same seed, at a small vocabulary.
"""

import numpy as np
import pytest

from kaldi_tpu.pipelines import largevocab as jlv
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import GaussStats, build_tree
from kaldi_tpu_torch.fst import Lang, Lexicon, arpa_to_fst, mkgraph
from kaldi_tpu_torch.fst.arpa import estimate_arpa
from kaldi_tpu_torch.fst.biglang import build_big_graph
from kaldi_tpu_torch.fst.csr import pack_fst
from kaldi_tpu_torch.pipelines import largevocab as tlv
from kaldi_tpu_torch.pipelines.tri import cluster_phone_questions
from test_biglang_cd import _all_paths, _lexicon
from test_biglang_cd import _setup as jax_setup

CSR_FIELDS = ("e_offsets", "e_ilabel", "e_olabel", "e_weight",
              "e_nextstate", "n_offsets", "n_olabel", "n_weight",
              "n_nextstate", "final_costs")


def _setup(rng, n_words, order=3, topo_kind="chain", leaves=40):
    """tests/test_biglang_cd.py ``_setup`` on the port's modules."""
    entries = _lexicon(rng, n_words)
    ws = [w for w, _ in entries]
    texts = [[ws[int(k)] for k in rng.integers(0, len(ws),
                                               int(rng.integers(1, 6)))]
             for _ in range(200)]
    arpa = estimate_arpa(texts, order=order, prune_count=1, vocab=ws)
    lang = Lang(Lexicon(list(entries)))
    pl = lang.phone_list()
    topo = (HmmTopology.chain(pl) if topo_kind == "chain"
            else HmmTopology.three_state(pl))
    npc = 1 if topo_kind == "chain" else 3
    stats = {}
    for ph in pl:
        for left in [0] + pl:
            for right in [0] + pl:
                for pc in range(npc):
                    g = GaussStats(3)
                    mean = np.array([ph, 0.31 * left + 0.17 * right,
                                     0.5 * pc])
                    for _ in range(4):
                        g.accumulate(mean + 0.05 * rng.standard_normal(3))
                    stats[((left, ph, right), pc)] = g
    questions = cluster_phone_questions(stats)
    tree = build_tree(stats, questions, 3, 1, max_leaves=leaves)
    assert tree.context_width == 3
    return entries, arpa, lang, TransitionModel(topo, tree), tree


@pytest.mark.parametrize("topo_kind", ["chain", "three_state"])
def test_cd_biglang_path_map_equals_mkgraph(topo_kind):
    """The port's direct CD construction and its generic triphone
    mkgraph accept the same (tids, words) → least cost maps, and the
    mkgraph graph equals the JAX package's."""
    entries, arpa, lang, tm, tree = _setup(
        np.random.default_rng(7), 3, order=2, topo_kind=topo_kind,
        leaves=25)
    ref_fst = mkgraph(lang, tm, arpa_to_fst(arpa, lang.words),
                      self_loop_scale=1.0)
    csr_ref = pack_fst(ref_fst)
    big = build_big_graph(entries, arpa, tm, lang.words, lang.phones,
                          self_loop_scale=1.0)
    t2p = tm.tid_to_pdf_array
    n_paths = 0
    for T in ([1, 2, 3, 4] if topo_kind == "chain" else [2, 4, 6]):
        ref = _all_paths(csr_ref, T, t2p)
        got = _all_paths(big.csr, T, t2p)
        assert set(ref) == set(got)
        for k, c in ref.items():
            assert abs(got[k] - c) < 1e-3, (T, k, c, got[k])
        n_paths += len(ref)
    assert n_paths > 0
    from kaldi_tpu.fst import arpa_to_fst as jarpa_to_fst
    from kaldi_tpu.fst import mkgraph as jmkgraph
    _, jarpa, jlang, jtm, _ = jax_setup(np.random.default_rng(7), 3,
                                        order=2, topo_kind=topo_kind,
                                        leaves=25)
    jref = jmkgraph(jlang, jtm, jarpa_to_fst(jarpa, jlang.words),
                    self_loop_scale=1.0)
    assert [[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate)
             for a in arcs] for arcs in ref_fst.arcs] == \
        [[(a.ilabel, a.olabel, np.float32(a.weight), a.nextstate)
          for a in arcs] for arcs in jref.arcs]


@pytest.mark.parametrize("seed", [3, 11])
def test_biphone_largevocab_task_equals_jax(seed):
    kw = dict(vocab_size=60, seed=seed, context="biphone",
              corpus_sentences=200, num_phones=12)
    j = jlv.make_largevocab_task(**kw)
    t = tlv.make_largevocab_task(**kw)
    assert t.tree.context_width == 2 and t.num_pdfs == j.num_pdfs
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(t.graph.csr, f),
                                      getattr(j.graph.csr, f))
    assert t.fwd_pdf == j.fwd_pdf and t.slf_pdf == j.slf_pdf
    evals = tlv.sample_eval_set(t, 4, max_words=5, seed=9)
    assert evals == jlv.sample_eval_set(j, 4, max_words=5, seed=9)
    for u in sorted(evals):
        got = tlv.synth_loglikes(t, evals[u], np.random.default_rng(1))
        want = jlv.synth_loglikes(j, evals[u], np.random.default_rng(1))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="mono|biphone"):
        tlv.make_largevocab_task(vocab_size=40, num_phones=6,
                                 context="triphone", corpus_sentences=20)
