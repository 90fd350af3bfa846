"""Context-dependent (left-biphone) chain trees in the PyTorch port:
tests/test_chain_cd.py's five tests held on the port's modules and
against the JAX package's functions on the same seeded trees.

Each side builds its tree, denominator graph, egs and decode graph from
the same seeded statistics with its own modules; the arrays must be
equal, the den log-probabilities and the trained objective close.  The
training smoke carries the JAX trainer's initial weights across
(``params_from_flax``), so the two trainings' objectives agree.
"""

import numpy as np
import pytest
import torch

import kaldi_tpu.am.chain as jchain
from kaldi_tpu.am import HmmTopology as JTopo
from kaldi_tpu.am import TransitionModel as JTm
from kaldi_tpu.am.tree import GaussStats as JStats
from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
from kaldi_tpu.am.tree import build_tree as jbuild
from kaldi_tpu.pipelines.tri import cluster_phone_questions as jquestions
from kaldi_tpu_torch.am import chain as tchain
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import (GaussStats, MonophoneContextDependency,
                                     build_tree)
from kaldi_tpu_torch.pipelines.tri import cluster_phone_questions

torch.set_num_threads(1)

PHONES = [1, 2, 3, 4]
JAX = dict(Topo=JTopo, Tm=JTm, Stats=JStats, Mono=JMono, build=jbuild,
           questions=jquestions, chain=jchain)
PORT = dict(Topo=HmmTopology, Tm=TransitionModel, Stats=GaussStats,
            Mono=MonophoneContextDependency, build=build_tree,
            questions=cluster_phone_questions, chain=tchain)
DEN_FIELDS = ("src", "dst", "pdf", "logw", "final", "initial",
              "state_entry_pdf")


def _biphone_tree(side, seed, leaves=12):
    """tests/test_chain_cd.py ``_biphone_tree`` on one side's modules."""
    rng = np.random.default_rng(seed)
    topo = side["Topo"].chain(PHONES)
    stats = {}
    for ph in PHONES:
        for left in [0] + PHONES:
            for pc in range(2):
                g = side["Stats"](2)
                mean = np.array([ph + 0.3 * left, 0.7 * pc])
                for _ in range(5):
                    g.accumulate(mean + 0.05 * rng.standard_normal(2))
                stats[((left, ph), pc)] = g
    questions = side["questions"](stats, central_position=1)
    tree = side["build"](stats, questions, 2, 1, max_leaves=leaves)
    return tree, topo, rng


def _phone_seqs(rng, n=40):
    return [[PHONES[int(k)] for k in rng.integers(0, len(PHONES),
                                                  int(rng.integers(2, 7)))]
            for _ in range(n)]


def _same_den(a, b):
    assert a.num_states == b.num_states
    for f in DEN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert a.exp_index == b.exp_index


def test_biphone_den_graph_invariants():
    """The original's invariants on the port's graph, which equals the
    JAX package's array for array."""
    dens = {}
    for name, side in (("port", PORT), ("jax", JAX)):
        tree, topo, rng = _biphone_tree(side, 3)
        dens[name] = side["chain"].make_denominator_graph(
            _phone_seqs(rng), tree, topo, order=3)
    den = dens["port"]
    _same_den(den, dens["jax"])
    S = den.num_states
    n_len2 = sum(1 for h in den.lm.hists if len(h) == 2)
    assert S >= n_len2
    cross = den.src != den.dst
    assert (den.pdf[cross] == den.state_entry_pdf[den.dst[cross]]).all()
    mass = np.zeros(S)
    np.add.at(mass, den.src, np.exp(den.logw.astype(np.float64)))
    mass += np.exp(den.final.astype(np.float64))
    assert np.allclose(mass, 1.0, atol=1e-4)
    last = np.asarray([h[-1] for h in den.lm.hists])
    eg = np.asarray([g for g, _ in sorted(den.exp_index,
                                          key=den.exp_index.get)])
    centers = last[eg]
    assert any(len(set(den.state_entry_pdf[centers == c].tolist())) > 1
               for c in set(centers.tolist())), "no left-context split"
    nv = den.norm_view()
    assert all(len(a) == den.lm.num_states for a in nv)
    h = den.lm.hists[[i for i, x in enumerate(den.lm.hists)
                      if len(x) == 2][0]]
    hist_ids = [den.lm.phones[i] for i in h]
    assert np.isfinite(den.initial_for(hist_ids))
    assert den.initial_for(hist_ids) == dens["jax"].initial_for(hist_ids)


def _context_free(side, rng_seed):
    rng = np.random.default_rng(rng_seed)
    topo = side["Topo"].chain(PHONES)
    stats = {}
    for ph in PHONES:
        for left in [0] + PHONES:
            for pc in range(2):
                g = side["Stats"](2)
                mean = np.array([3.0 * ph, 2.0 * pc])
                for _ in range(5):
                    g.accumulate(mean + 0.01 * rng.standard_normal(2))
                stats[((left, ph), pc)] = g
    questions = side["questions"](stats, central_position=1)
    tree2 = side["build"](stats, questions, 2, 1,
                          max_leaves=2 * len(PHONES))
    mono = side["Mono"](PHONES, topo)
    seqs = _phone_seqs(rng)
    den2 = side["chain"].make_denominator_graph(seqs, tree2, topo, order=2)
    den1 = side["chain"].make_denominator_graph(seqs, mono, topo, order=2)
    return rng, topo, tree2, mono, den1, den2


def test_biphone_den_matches_mono_shape_when_context_free():
    """A width-2 tree that never splits on the left phone gives the mono
    construction's den log-probs on the port (its CPU recursion), and
    both equal the JAX package's within 1e-4 relative."""
    import jax.numpy as jnp
    rng, topo, tree2, mono, den1, den2 = _context_free(PORT, 5)
    _, _, _, _, jden1, jden2 = _context_free(JAX, 5)
    _same_den(den1, jden1)
    _same_den(den2, jden2)
    B, T = 3, 12
    x1 = rng.standard_normal((B, T, den1.pdf.max() + 1)).astype(np.float32)
    x2 = np.zeros((B, T, int(den2.pdf.max()) + 1), np.float32)
    for ph in PHONES:
        st = topo.topology_for_phone(ph)[0]
        for cls in (st.forward_pdf_class, st.self_loop_pdf_class):
            x2[:, :, tree2.compute([0, ph], cls)] = \
                x1[:, :, mono.compute([ph], cls)]
    z1 = tchain.denominator_logprob(den1, torch.tensor(x1)).numpy()
    z2 = tchain.denominator_logprob(den2, torch.tensor(x2)).numpy()
    np.testing.assert_allclose(z1, z2, rtol=1e-4, atol=1e-3)
    jz2 = np.asarray(jchain.denominator_logprob(jden2, jnp.asarray(x2)))
    np.testing.assert_allclose(z2, jz2, rtol=1e-4, atol=1e-4)


def test_biphone_biglang_matches_mkgraph():
    """Decode-graph parity at (2,1): the port's direct construction
    accepts the same (tids, words) paths at the same least cost as its
    generic mkgraph pipeline, and equals the JAX package's graph."""
    from kaldi_tpu.fst.biglang import build_big_graph as jbig
    from kaldi_tpu_torch.fst import Lang, Lexicon, arpa_to_fst, mkgraph
    from kaldi_tpu_torch.fst.arpa import estimate_arpa
    from kaldi_tpu_torch.fst.biglang import build_big_graph
    from kaldi_tpu_torch.fst.csr import pack_fst
    from test_biglang_cd import _all_paths, _lexicon
    from test_torch_biglang_cd import CSR_FIELDS
    rng = np.random.default_rng(7)
    entries = _lexicon(rng, 3)
    ws = [w for w, _ in entries]
    texts = [[ws[int(k)] for k in rng.integers(0, len(ws),
                                               int(rng.integers(1, 6)))]
             for _ in range(150)]
    arpa = estimate_arpa(texts, order=2, prune_count=1, vocab=ws)
    lang = Lang(Lexicon(list(entries)))
    pl = lang.phone_list()
    graphs = {}
    for name, side in (("port", PORT), ("jax", JAX)):
        srng = np.random.default_rng(70)
        topo = side["Topo"].chain(pl)
        stats = {}
        for ph in pl:
            for left in [0] + pl:
                for pc in range(2):
                    g = side["Stats"](2)
                    mean = np.array([ph + 0.31 * left, 0.9 * pc])
                    for _ in range(4):
                        g.accumulate(mean + 0.05 * srng.standard_normal(2))
                    stats[((left, ph), pc)] = g
        tree = side["build"](stats, side["questions"](
            stats, central_position=1), 2, 1, max_leaves=20)
        tm = side["Tm"](topo, tree)
        build = build_big_graph if name == "port" else jbig
        graphs[name] = (tm, build(entries, arpa, tm, lang.words,
                                  lang.phones, self_loop_scale=1.0))
    tm, big = graphs["port"]
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(big.csr, f)),
            np.asarray(getattr(graphs["jax"][1].csr, f)), err_msg=f)
    csr_ref = pack_fst(mkgraph(lang, tm, arpa_to_fst(arpa, lang.words),
                               self_loop_scale=1.0))
    t2p = tm.tid_to_pdf_array
    for T in (1, 2, 3, 4):
        ref = _all_paths(csr_ref, T, t2p)
        got = _all_paths(big.csr, T, t2p)
        assert set(ref) == set(got), f"T={T}"
        for k, c in ref.items():
            assert abs(got[k] - c) < 1e-3, (T, k, c, got[k])


def _cd_setup(side, seed=11):
    """The original smoke's synthetic GMM alignments, chain tree, den
    graph and CD egs on one side's modules."""
    chain_pipe = (__import__("kaldi_tpu_torch.pipelines.chain",
                             fromlist=["x"]) if side is PORT else
                  __import__("kaldi_tpu.pipelines.chain", fromlist=["x"]))
    rng = np.random.default_rng(seed)
    topo3 = side["Topo"].three_state(PHONES)
    tree3 = side["Mono"](PHONES, topo3)
    tm3 = side["Tm"](topo3, tree3)
    feats, ali = {}, {}
    Dm = 8
    for u in range(12):
        tids = []
        for _ in range(int(rng.integers(3, 7))):
            ph = PHONES[int(rng.integers(len(PHONES)))]
            dur = int(rng.integers(3, 7))
            for st in range(3):
                ts = tm3.tuple_to_transition_state(
                    ph, st, tree3.compute([ph], st), tree3.compute([ph], st))
                tids.append(tm3.pair_to_transition_id(ts, 0))
                for _ in range(max(0, dur // 3 - 1)):
                    tids.append(tm3.self_loop_of(ts))
        ali[f"u{u}"] = tids
        feats[f"u{u}"] = rng.standard_normal((len(tids), Dm)).astype(
            np.float32)
    chain_topo = side["Topo"].chain(PHONES)
    tree = chain_pipe.build_chain_tree(feats, ali, tm3, chain_topo,
                                       num_leaves=16)
    seqs = [tm3.alignment_to_phones(ali[u]) for u in sorted(ali)]
    den = side["chain"].make_denominator_graph(seqs, tree, chain_topo,
                                               order=2)
    runs = {u: chain_pipe.phone_alignment_runs(tm3, ali[u]) for u in ali}
    egs = chain_pipe.make_chain_egs(feats, runs, tree, chain_topo,
                                    chunk_size=9, subsample=3, den=den)
    return tree, den, egs, Dm, chain_pipe


def test_chain_cd_train_smoke():
    """build_chain_tree from a GMM alignment, the biphone den graph and
    CD egs equal the JAX package's; both trainers from the JAX trainer's
    initial weights end at a finite, normalized objective (≤ 0.05) within
    1e-3 of each other."""
    from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
    from kaldi_tpu_torch.am.tdnn import TdnnConfig, params_from_flax
    from test_torch_parallel import jax_tree_to_numpy
    tree, den, egs, Dm, tpipe = _cd_setup(PORT)
    jtree, jden, jegs, _, jpipe = _cd_setup(JAX)
    assert tree.context_width == 2 and tree.num_pdfs == jtree.num_pdfs
    _same_den(den, jden)
    for f in ("feats", "pdf_ali", "mask", "entry_pdf", "self_pdf",
              "num_segs", "entry_w", "self_w", "init_w", "final_w"):
        np.testing.assert_array_equal(getattr(egs, f), getattr(jegs, f),
                                      err_msg=f)
    width = dict(feat_dim=Dm, num_pdfs=tree.num_pdfs, hidden_dim=32,
                 bottleneck_dim=16, num_layers=2, frame_subsampling_factor=3)
    train = dict(num_epochs=2, batch_size=4, learning_rate=1e-3)
    jt = jpipe.ChainTrainer(JCfg(**width), jden,
                            jpipe.ChainTrainConfig(**train), seed=0)
    init = params_from_flax({"params": jax_tree_to_numpy(jt.params),
                             "batch_stats": jax_tree_to_numpy(
                                 jt.batch_stats)})
    tr = tpipe.ChainTrainer(TdnnConfig(**width), den,
                            tpipe.ChainTrainConfig(**train), device="cpu")
    tr.load_state_dict(init)
    out = tr.train(egs)
    jout = jt.train(jegs)
    assert np.isfinite(out["objf"])
    assert out["objf"] <= 0.05
    assert abs(out["objf"] - jout["objf"]) < 1e-3


def test_largevocab_biphone_context_option():
    """make_largevocab_task(context='biphone') builds the JAX package's
    CD graph, and synthetic loglikes peaked on context-aware pdfs decode
    at under 5% WER through the port's BeamDecoder on the CPU."""
    from kaldi_tpu.pipelines import largevocab as jlv
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.pipelines import largevocab as tlv
    from kaldi_tpu_torch.pipelines.score import compute_wer
    from test_torch_biglang_cd import CSR_FIELDS
    kw = dict(vocab_size=300, num_phones=12, corpus_sentences=800, seed=3,
              context="biphone")
    task = tlv.make_largevocab_task(**kw)
    jtask = jlv.make_largevocab_task(**kw)
    for f in CSR_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(task.graph.csr, f)),
            np.asarray(getattr(jtask.graph.csr, f)), err_msg=f)
    assert task.tree.context_width == 2
    pl = sorted(task.topo.phones)
    assert any(len({task.pdf_pair(l, p)[0] for l in [0] + pl}) > 1
               for p in pl)
    eval_set = tlv.sample_eval_set(task, 12, max_words=5, seed=5)
    rng = np.random.default_rng(9)
    lls = {u: tlv.synth_loglikes(task, s, rng, noise=0.3, peak=6.0)
           for u, s in eval_set.items()}
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                      BeamDecoderConfig(beam=13.0, max_active=2000,
                                        acoustic_scale=1.0,
                                        lattice_beam=6.0, arc_budget=8192,
                                        lattice_arcs_per_frame=2048),
                      device="cpu")
    hyps = {}
    for u in sorted(lls):
        clat = dec.decode_compact(lls[u], bucket=16)
        hyps[u] = [task.words.find(w) for w in clat.best_path()[0]]
    wer = compute_wer(eval_set, hyps)
    assert wer.wer < 5.0, str(wer)
