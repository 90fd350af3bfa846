"""The port's RNNLM (kaldi_tpu_torch/lm/rnnlm.py) against the JAX
package's (kaldi_tpu/lm/rnnlm.py, flax + optax), on the CPU at V = 30,
E = 8, H = 12.

* The same weights (``params_from_flax`` of perturbed flax parameters,
  every bias nonzero) give the same logits and carry (rtol 1e-5 of the
  largest magnitude), the same perplexity (rtol 1e-5) and the same
  scorer log-probs over a set of histories (atol 1e-5).
* One training step from the JAX run's initial weights (the port's
  initialiser monkeypatched to hand them over): the same loss (rtol
  1e-5) and parameters after Adam (atol 1e-3 of the learning rate: a
  first Adam step moves each weight by ±lr·g/(|g| + eps)), with the
  full softmax and with the sampled one on the JAX run's Gumbel-top-k
  candidates (the test replays ``jax.random.split(PRNGKey(seed + 1))``).
* ``unigram_proposal`` equals the original's exactly; the initial
  weights have flax's moments.
* Model files cross both ways: the port reads the original's file bit
  for bit and writes the same bytes for the same trained weights, and
  the original's ``load_rnnlm`` reads the port's file.
* The original's tests of the RNNLM (tests/test_lm_kws_misc.py
  ``test_rnnlm_*``) on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.fst.fst import SymbolTable as JSymbolTable
from kaldi_tpu.lm import rnnlm as J
from kaldi_tpu_torch.core import msgpack
from kaldi_tpu_torch.fst.fst import SymbolTable
from kaldi_tpu_torch.lm import rnnlm as T

torch.set_num_threads(1)

V, E, H = 30, 8, 12
FWD_RTOL = 1e-5
LOSS_RTOL = 1e-5
LR = 1e-2
# a first Adam step moves a weight by Δ = lr·g/(|g| + eps), eps 1e-8:
# each side's Δ within 1e-3·lr, plus Δ's sensitivity to a gradient error
# of GRAD_RTOL of the tensor's largest gradient, lr·eps·δg/(|g| + eps)²
# (near |g| = eps, float32 rounding of g moves Δ by up to a step)
STEP_ATOL = 1e-3 * LR
GRAD_RTOL = 1e-5
ADAM_EPS = 1e-8


def sentences(n=24, seed=0, vocab=V):
    rng = np.random.default_rng(seed)
    return [[int(w) for w in rng.integers(3, vocab, rng.integers(1, 7))]
            for _ in range(n)]


def jax_params(seed=0, cfg=None, scale=0.3):
    """The JAX model's initial parameters, every leaf (biases too)
    perturbed by seeded noise, as numpy arrays."""
    cfg = cfg or J.RnnLmConfig(vocab_size=V, embed_dim=E, hidden_dim=H)
    p = J.RnnLm(cfg).init(jax.random.PRNGKey(seed),
                          jnp.zeros((2, 3), jnp.int32))["params"]
    rng = np.random.default_rng(seed + 100)
    return cfg, jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), p)


def port_model(params, cfg):
    m = T.RnnLm(T.RnnLmConfig(cfg.vocab_size, cfg.embed_dim,
                              cfg.hidden_dim))
    m.load_state_dict(T.params_from_flax(params))
    return m


def rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_forward_matches_flax_with_its_weights():
    cfg, p = jax_params()
    model = port_model(p, cfg)
    tok = np.random.default_rng(1).integers(0, V, (3, 9))
    h0 = np.random.default_rng(2).standard_normal((3, H)).astype(np.float32)
    jl, jc = J.RnnLm(cfg).apply({"params": p}, jnp.asarray(tok),
                                jnp.asarray(h0))
    with torch.no_grad():
        tl, tc = model(torch.from_numpy(tok), torch.from_numpy(h0))
        hs, hc = model.encode(torch.from_numpy(tok))
    jhs, jhc = J.RnnLm(cfg).apply({"params": p}, jnp.asarray(tok),
                                  method=J.RnnLm.encode)
    assert rel_max(tl, jl) <= FWD_RTOL
    assert rel_max(tc, jc) <= FWD_RTOL
    assert rel_max(hs, jhs) <= FWD_RTOL
    assert rel_max(hc, jhc) <= FWD_RTOL


def test_params_cross_both_ways_exactly():
    cfg, p = jax_params(seed=3)
    model = port_model(p, cfg)
    back = T.params_to_flax(model)
    flat_p = jax.tree_util.tree_leaves_with_path(p)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_p] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_p, flat_b):
        np.testing.assert_array_equal(a, b)
    # exactly flax's parameter set: no bias on hr / hz
    names = sorted(n for n, _ in model.named_parameters())
    assert "gru.hr.bias" not in names and "gru.hz.bias" not in names
    assert len(names) == 13


@pytest.mark.parametrize("power,eos", [(0.75, 2), (0.5, 5)])
def test_unigram_proposal_equals_original(power, eos):
    s = sentences(40, seed=4)
    np.testing.assert_array_equal(T.unigram_proposal(s, V, power, eos),
                                  J.unigram_proposal(s, V, power, eos))


def test_init_draws_flax_distributions():
    """Fresh weights as flax draws them: the embedding a normal of std
    1/√E, the input and output kernels a normal truncated at ±2 with
    std 1/√fan_in (E for the input kernels, H for the output), the
    recurrent kernels orthogonal, biases zero; the flax init's moments
    agree."""
    cfg = T.RnnLmConfig(vocab_size=500, embed_dim=64, hidden_dim=96)
    m = T.init_rnnlm(T.RnnLm(cfg), seed=1)
    jp = J.RnnLm(J.RnnLmConfig(500, 64, 96)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 2), jnp.int32))["params"]
    pairs = [(m.embed.embedding, jp["embed"]["embedding"], 64, False),
             (m.gru.ir.kernel, jp["gru"]["ir"]["kernel"], 64, True),
             (getattr(m.gru, "in").kernel, jp["gru"]["in"]["kernel"], 64,
              True),
             (m.output.kernel, jp["output"]["kernel"], 96, True)]
    for w, jw, fan_in, truncated in pairs:
        w = w.detach().numpy()
        for x in (w, np.asarray(jw)):
            assert x.std() == pytest.approx(1 / np.sqrt(fan_in), rel=0.05)
            assert abs(x.mean()) < 0.5 / np.sqrt(fan_in)
            top = np.abs(x).max() * np.sqrt(fan_in)
            # a truncated draw stays within 2 / 0.8796 of its std; 32,000
            # untruncated draws pass 3 of it
            assert (top <= 2.0 / 0.8796 + 1e-5) == truncated
    for name in ("hr", "hz", "hn"):
        for w in (getattr(m.gru, name).kernel.detach().numpy(),
                  np.asarray(jp["gru"][name]["kernel"])):
            np.testing.assert_allclose(w.T @ w, np.eye(96), atol=1e-5)
    for name in ("ir", "iz", "in", "hn"):
        assert not getattr(m.gru, name).bias.detach().any()
    assert not m.output.bias.detach().any()
    again = T.init_rnnlm(T.RnnLm(cfg), seed=1)
    assert torch.equal(again.gru.hr.kernel, m.gru.hr.kernel)


def _jax_candidates(sents, sample_k, seed):
    """The JAX run's first Gumbel-top-k draw: its first split of
    PRNGKey(seed + 1)."""
    log_q = jnp.asarray(np.log(J.unigram_proposal(sents, V)))
    _, sub = jax.random.split(jax.random.PRNGKey(seed + 1))
    _, cand = jax.lax.top_k(log_q + jax.random.gumbel(sub, (V,)), sample_k)
    return torch.from_numpy(np.asarray(cand).astype(np.int64))


def _hand_over(monkeypatch, sents, sample_k, seed, corpus=None):
    """Make the port's train_rnnlm start from the JAX run's initial
    weights (and draw its candidates, over the proposal of ``corpus``,
    default ``sents``) → (initial flax tree, the port's gradient there
    over all of ``sents`` as a flax tree)."""
    corpus = corpus or sents
    cfg = J.RnnLmConfig(vocab_size=V, embed_dim=E, hidden_dim=H)
    inp = np.zeros((2, max(len(x) for x in sents) + 1), np.int32)
    init = jax.tree_util.tree_map(np.asarray, J.RnnLm(cfg).init(
        jax.random.PRNGKey(seed), inp)["params"])

    def from_jax(model, seed=0):
        model.load_state_dict(T.params_from_flax(init))
        return model

    monkeypatch.setattr(T, "init_rnnlm", from_jax)
    model = port_model(init, cfg)
    xi, xt, xm = (torch.from_numpy(a)
                  for a in T.frame_sentences(sents, 1, 2))
    if sample_k:
        cand = _jax_candidates(corpus, sample_k, seed)
        monkeypatch.setattr(T, "draw_candidates", lambda lq, k, gen: cand)
        log_q = torch.from_numpy(np.log(T.unigram_proposal(corpus, V)))
        loss = T.sampled_softmax_loss(model, xi, xt, xm, log_q, cand)
    else:
        loss = T.full_softmax_loss(model, xi, xt, xm)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.data.copy_(grads[n])
    return init, T.params_to_flax(model)


def assert_first_adam_step(got, want, init, grads):
    """``got`` and ``want`` (flax trees after one Adam step from ``init``
    at LR) within STEP_ATOL plus the step's sensitivity to a gradient
    error of GRAD_RTOL (``grads`` the port's gradient at ``init``); some
    weights moved."""
    moved = 0
    for (path, w), (_, g), (_, x0), (_, dg) in zip(
            *(jax.tree_util.tree_leaves_with_path(t)
              for t in (want, got, init, grads))):
        g64, dg = np.asarray(g, np.float64), np.abs(np.asarray(dg,
                                                               np.float64))
        err = GRAD_RTOL * dg.max()
        tol = STEP_ATOL + LR * ADAM_EPS * err / (dg + ADAM_EPS) ** 2
        bad = np.abs(g64 - np.asarray(w, np.float64)) > tol
        assert not bad.any(), (jax.tree_util.keystr(path), int(bad.sum()))
        moved += int((g64 != np.asarray(x0, np.float64)).sum())
    assert moved > 0


def _one_step(monkeypatch, sample_k, seed=5):
    """One Adam step on both sides from the JAX run's initial weights:
    N = B sentences, one epoch.  → (port model, JAX params, port loss,
    JAX loss, initial weights, the port's gradient there)."""
    s = sentences(16, seed=seed)
    cfg = J.RnnLmConfig(vocab_size=V, embed_dim=E, hidden_dim=H)
    init, grads = _hand_over(monkeypatch, s, sample_k, seed)
    losses = []
    orig = J.log.info
    stats = {}
    model = T.train_rnnlm(s, T.RnnLmConfig(V, E, H), num_epochs=1,
                          batch_size=16, learning_rate=LR, seed=seed,
                          sample_k=sample_k, device="cpu", stats=stats)
    monkeypatch.setattr(J.log, "info", lambda fmt, *a: losses.append(a[1])
                        if fmt.startswith("rnnlm epoch") else orig(fmt, *a))
    params, _ = J.train_rnnlm(s, cfg, num_epochs=1, batch_size=16,
                              learning_rate=LR, seed=seed,
                              sample_k=sample_k)
    assert stats["steps"] == 1
    return model, jax.tree_util.tree_map(np.asarray, params), \
        stats["nll"], losses[0], init, grads


@pytest.mark.parametrize("sample_k", [None, 7], ids=["full", "sampled"])
def test_one_training_step_matches_optax(monkeypatch, sample_k):
    model, params, loss, jloss, init, grads = _one_step(monkeypatch,
                                                        sample_k)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    assert_first_adam_step(T.params_to_flax(model), params, init, grads)


def test_sampled_loss_masks_accidental_hits():
    """A candidate equal to a target drops out of that target's
    normaliser: the loss with every target among the candidates equals
    the loss over the remaining candidates alone."""
    cfg, p = jax_params(seed=7)
    model = port_model(p, cfg)
    xi = torch.tensor([[1, 4, 5]])
    xt = torch.tensor([[4, 5, 2]])
    xm = torch.tensor([[True, True, True]])
    log_q = torch.log(torch.full((V,), 1.0 / V))
    with torch.no_grad():
        a = T.sampled_softmax_loss(model, xi, xt, xm, log_q,
                                   torch.tensor([4, 9, 11]))
        b = T.sampled_softmax_loss(model, xi, xt, xm, log_q,
                                   torch.tensor([9, 11, 4]))
    assert math.isfinite(float(a)) and float(a) == pytest.approx(float(b))


def test_perplexity_matches_original():
    cfg, p = jax_params(seed=8)
    model = port_model(p, cfg)
    held = sentences(11, seed=9)
    want = J.perplexity(p, J.RnnLm(cfg), held)
    assert T.perplexity(model, held, batch=4) == pytest.approx(
        want, rel=1e-5)
    assert T.perplexity(model, held, bos=3, eos=4) == pytest.approx(
        J.perplexity(p, J.RnnLm(cfg), held, bos=3, eos=4), rel=1e-5)


def _tables():
    words = [("<eps>", 0), ("<s>", 1), ("</s>", 2)] + [
        (f"w{i}", i) for i in range(3, V)]
    t, j = SymbolTable(), JSymbolTable()
    for w, i in words:
        t.add(w, i)
        j.add(w, i)
    return t, j


def test_scorer_matches_original():
    """Log-probs over histories that share prefixes, restart at <s> and
    carry unknown words (id 0), with one GRU step per new history."""
    cfg, p = jax_params(seed=10)
    model = port_model(p, cfg)
    tw, jw = _tables()
    ts = T.RnnLmScorer(model, tw, device="cpu")
    js = J.RnnLmScorer(p, J.RnnLm(cfg), jw)
    hists = [(), ("w3",), ("w3", "w4"), ("w3", "w4", "w5"), ("<s>", "w7"),
             ("w9", "zzz", "w4"), ("w3", "w4")]
    for h in hists:
        for w in ("w3", "w8", "</s>", "zzz"):
            assert ts.score(h, w) == pytest.approx(js.score(h, w), abs=1e-5)
    # unique histories with <s>: (), w3, w3w4, w3w4w5, w7, w9, w9 zzz,
    # w9 zzz w4 — plus <s> itself
    assert ts.steps == len(ts._cache) == 8


def test_model_files_cross_both_ways(tmp_path):
    cfg, p = jax_params(seed=11)
    jpath, tpath = str(tmp_path / "j.rnnlm"), str(tmp_path / "t.rnnlm")
    J.save_rnnlm(jpath, p, cfg)
    model = T.load_rnnlm(jpath, device="cpu")
    assert model.config == T.RnnLmConfig(V, E, H)
    got = T.params_to_flax(model)
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(p),
                              jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_array_equal(a, b)
    T.save_rnnlm(tpath, model)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    jp, jm = J.load_rnnlm(tpath)
    assert jm.config == cfg
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(p),
                              jax.tree_util.tree_leaves_with_path(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_msgpack_matches_flax_bytes():
    import flax.serialization as fser
    _, p = jax_params(seed=12)
    tree = {"b": {"x": np.arange(70000, dtype=np.float32)},
            "a": {"y": np.zeros((), np.float32), "z": np.arange(5)}, **p}
    assert msgpack.packb(tree) == fser.to_bytes(tree)
    back = msgpack.unpackb(fser.to_bytes(tree))
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.asarray(w).dtype


def _pattern_words():
    words = SymbolTable()
    for sym, i in [("<eps>", 0), ("<s>", 1), ("</s>", 2), ("A", 3),
                   ("B", 4)]:
        words.add(sym, i)
    return words


def test_rnnlm_learns_pattern():
    """Mirrors test_lm_kws_misc.py::test_rnnlm_learns_pattern."""
    cfg = T.RnnLmConfig(vocab_size=8, embed_dim=16, hidden_dim=32)
    s = [[3, 4, 3, 4], [3, 4], [3, 4, 3, 4, 3, 4]] * 5
    model = T.train_rnnlm(s, cfg, num_epochs=60, learning_rate=1e-2,
                          device="cpu")
    scorer = T.RnnLmScorer(model, _pattern_words(), device="cpu")
    lp_b = scorer.score(("A",), "B")
    assert lp_b > scorer.score(("A",), "A") + 1.0
    assert scorer.score(("A", "B", "A"), "B") > math.log(0.5)
    assert scorer.score(("A",), "B") == lp_b


def test_rnnlm_sampled_softmax_matches_full():
    """Mirrors test_lm_kws_misc.py::test_rnnlm_sampled_softmax_matches_full."""
    cfg = T.RnnLmConfig(vocab_size=64, embed_dim=16, hidden_dim=32)
    s = [[3, 4, 3, 4], [3, 4], [3, 4, 3, 4, 3, 4]] * 5
    q = T.unigram_proposal(s, 64)
    assert abs(float(q.sum()) - 1.0) < 1e-5 and q.min() > 0
    full = T.train_rnnlm(s, cfg, num_epochs=60, learning_rate=1e-2,
                         device="cpu")
    samp = T.train_rnnlm(s, cfg, num_epochs=60, learning_rate=1e-2,
                         sample_k=12, device="cpu")
    ppl_f = T.perplexity(full, [[3, 4, 3, 4]])
    ppl_s = T.perplexity(samp, [[3, 4, 3, 4]])
    assert ppl_f < 4.0
    assert ppl_s < max(2.0 * ppl_f, 6.0)


def test_rnnlm_rescoring_flips_lattice():
    """Mirrors test_lm_kws_misc.py::test_rnnlm_rescoring_flips_lattice."""
    from kaldi_tpu_torch.lattice import CompactArc, CompactLattice
    from kaldi_tpu_torch.lattice import compose_lm, nbest
    cfg = T.RnnLmConfig(vocab_size=8, embed_dim=16, hidden_dim=32)
    model = T.train_rnnlm([[3, 4], [3, 4, 3, 4]] * 8, cfg, num_epochs=60,
                          learning_rate=1e-2, device="cpu")
    c = CompactLattice()
    s = [c.add_state() for _ in range(3)]
    c.start = s[0]
    c.arcs[s[0]].append(CompactArc(3, 0.0, 0.0, (9,), s[1]))
    c.arcs[s[1]].append(CompactArc(3, 0.0, 0.0, (9,), s[2]))
    c.arcs[s[1]].append(CompactArc(4, 0.3, 0.0, (9,), s[2]))
    c.finals[s[2]] = (0.0, 0.0, ())
    assert nbest(c, 1)[0][0] == [3, 3]
    scorer = T.RnnLmScorer(model, _pattern_words(), device="cpu")
    resc = compose_lm(c, scorer.score, _pattern_words(), scale=1.0)
    assert nbest(resc, 1)[0][0] == [3, 4]


# -- the tools ----------------------------------------------------------------

RNNLM_TOOLS_9 = ["rnnlm-train", "rnnlm-compute-prob",
                 "lattice-lmrescore-kaldi-rnnlm", "rnnlm-get-egs",
                 "rnnlm-sentence-probs", "rnnlm-get-word-embedding",
                 "lattice-lmrescore-kaldi-rnnlm-pruned",
                 "lattice-lmrescore-rnnlm", "rnnlm-get-sampling-lm"]
# rescored lattice weights: float32 log-probs from two GRU implementations
LAT_TOL = 1e-4


@pytest.fixture(scope="module")
def tool_files(tmp_path_factory):
    """Integerized text, a seeded 300-word task's lattices (decoded by the
    port), its words.txt and trigram ARPA, and an RNNLM over its words
    (perturbed flax weights, V = the words' largest id + 1) written by
    the original's save_rnnlm."""
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.fst.arpa import write_arpa
    from kaldi_tpu_torch.pipelines import largevocab as tlv
    d = tmp_path_factory.mktemp("rnnlm_tools")
    p = {k: str(d / k) for k in ("text", "lat", "words", "arpa", "rnnlm",
                                 "big_rnnlm")}
    with TableWriter(f"ark,t:{p['text']}", holder="text") as w:
        for i, s in enumerate(sentences(24, seed=13)):
            w[f"s{i:02d}"] = [str(x) for x in s]
    task = tlv.make_largevocab_task(vocab_size=300, order=3, seed=7,
                                    closure=False, corpus_sentences=600)
    ev = tlv.sample_eval_set(task, 3, max_words=6, seed=21)
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
    with TableWriter(f"ark:{p['lat']}", holder="clat") as w:
        for u, lat in zip(sorted(ev), dec.decode_compact_batch(X, lens)):
            w[u] = lat
    task.words.write(p["words"])
    write_arpa(task.arpa, p["arpa"])
    cfg, params = jax_params(seed=14)
    J.save_rnnlm(p["rnnlm"], params, cfg)
    big = J.RnnLmConfig(vocab_size=max(task.words.ids()) + 1, embed_dim=E,
                        hidden_dim=H)
    _, big_params = jax_params(seed=15, cfg=big)
    J.save_rnnlm(p["big_rnnlm"], big_params, big)
    return p, (params, cfg), (big_params, big)


def _tools():
    from kaldi_tpu.cli import TOOLS as JTOOLS
    from kaldi_tpu_torch.cli import TOOLS as TTOOLS
    return TTOOLS, JTOOLS


def _clats(path):
    from kaldi_tpu_torch.core.table import SequentialTableReader
    return dict(SequentialTableReader(f"ark:{path}", holder="clat"))


def _same_lattices(got, want, tol):
    g, w = _clats(got), _clats(want)
    assert sorted(g) == sorted(w) and g
    for u in w:
        a, b = g[u], w[u]
        assert (a.start, a.num_states, sorted(a.finals)) == \
            (b.start, b.num_states, sorted(b.finals))
        for s in range(b.num_states):
            assert [(x.word, tuple(x.tids), x.nextstate) for x in a.arcs[s]] \
                == [(x.word, tuple(x.tids), x.nextstate) for x in b.arcs[s]]
            for x, y in zip(a.arcs[s], b.arcs[s]):
                assert x.graph_cost == pytest.approx(y.graph_cost, abs=tol)
                assert x.acoustic_cost == y.acoustic_cost
        for s, fin in b.finals.items():
            assert a.finals[s][0] == pytest.approx(fin[0], abs=tol)


def test_the_port_registers_the_nine_rnnlm_tools_and_const_arpa():
    TTOOLS, JTOOLS = _tools()
    for name in RNNLM_TOOLS_9 + ["arpa-to-const-arpa", "const-arpa-to-arpa"]:
        assert name in TTOOLS and name in JTOOLS
    assert len(TTOOLS) == 277       # with the nnet1 and nnet3 loop tools


@pytest.mark.parametrize("name,opts", [
    ("rnnlm-get-sampling-lm", ["--vocab-size=40"]),
    ("rnnlm-get-sampling-lm", ["--unigram-power=0.5"]),
    ("rnnlm-get-egs", ["--bos=3", "--eos=4"])])
def test_text_tools_write_the_originals_bytes(tool_files, tmp_path, name,
                                              opts):
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    outs = []
    for side, tools in (("t", TTOOLS), ("j", JTOOLS)):
        out = str(tmp_path / side)
        spec = out if name == "rnnlm-get-sampling-lm" else f"ark:{out}"
        assert tools[name](opts + [f"ark:{p['text']}", spec]) in (0, None)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and outs[0]
    if name == "rnnlm-get-sampling-lm":
        from kaldi_tpu.cli.tools_bank28 import read_sampling_lm as jread
        from kaldi_tpu_torch.cli.tools_rnnlm import read_sampling_lm
        np.testing.assert_array_equal(read_sampling_lm(str(tmp_path / "t")),
                                      jread(str(tmp_path / "j")))


@pytest.mark.parametrize("sample_k", [0, 7], ids=["full", "sampled"])
def test_rnnlm_train_tool_matches_original(tool_files, tmp_path,
                                           monkeypatch, sample_k):
    """rnnlm-train on 24 sentences, one epoch (one step of B = 16), from
    the JAX tool's initial weights and candidates: the model files hold
    the same weights after the step (``assert_first_adam_step``), and
    each side reads the other's."""
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    from kaldi_tpu_torch.core.table import SequentialTableReader
    sents = [[int(x) for x in v] for _, v in
             SequentialTableReader(f"ark:{p['text']}", holder="text")]
    # the tool's one batch: the first 16 of the seed-0 permutation
    batch = [sents[i] for i in np.random.default_rng(0).permutation(
        len(sents))[:16]]
    init, grads = _hand_over(monkeypatch, batch, sample_k, 0, corpus=sents)
    opts = [f"--vocab-size={V}", f"--embed-dim={E}", f"--hidden-dim={H}",
            "--num-epochs=1", "--learning-rate=0.01",
            f"--sample-k={sample_k}"]
    tout, jout = str(tmp_path / "t.rnnlm"), str(tmp_path / "j.rnnlm")
    assert TTOOLS["rnnlm-train"](opts + ["--device=cpu", f"ark:{p['text']}",
                                         tout]) in (0, None)
    assert JTOOLS["rnnlm-train"](opts + [f"ark:{p['text']}", jout]) in \
        (0, None)
    got = T.params_to_flax(T.load_rnnlm(tout, device="cpu"))
    want, _ = J.load_rnnlm(jout)
    assert_first_adam_step(got, jax.tree_util.tree_map(np.asarray, want),
                           init, grads)
    jp, _ = J.load_rnnlm(tout)
    assert T.load_rnnlm(jout, device="cpu").config.vocab_size == V
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(want)


def test_rnnlm_compute_prob_matches_original(tool_files, capsys):
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    assert TTOOLS["rnnlm-compute-prob"](["--device=cpu", p["rnnlm"],
                                        f"ark:{p['text']}"]) in (0, None)
    got = float(capsys.readouterr().out.split()[-1])
    assert JTOOLS["rnnlm-compute-prob"]([p["rnnlm"], f"ark:{p['text']}"]) \
        in (0, None)
    want = float(capsys.readouterr().out.split()[-1])
    assert got == pytest.approx(want, rel=1e-5)


def test_rnnlm_sentence_probs_gives_the_originals_log_probs(tool_files,
                                                           tmp_path):
    """Ported to intent (the original raises): each sentence's total
    natural-log probability, <s> to </s>, equals the JAX model's from
    its own forward (4 decimals written)."""
    from kaldi_tpu_torch.core.table import SequentialTableReader
    p, (params, cfg), _ = tool_files
    TTOOLS, _ = _tools()
    out = str(tmp_path / "probs")
    assert TTOOLS["rnnlm-sentence-probs"](["--device=cpu", "--bos=1",
                                          "--eos=2", p["rnnlm"],
                                          f"ark:{p['text']}",
                                          f"ark,t:{out}"]) in (0, None)
    got = {k: float(v[0]) for k, v in
           SequentialTableReader(f"ark,t:{out}", holder="text")}
    sents = {k: [int(x) for x in v] for k, v in
             SequentialTableReader(f"ark:{p['text']}", holder="text")}
    assert sorted(got) == sorted(sents)
    model = J.RnnLm(cfg)
    for k, ids in sents.items():
        logits, _ = model.apply({"params": params},
                                jnp.asarray([[1] + ids], jnp.int32))
        lp = np.asarray(jax.nn.log_softmax(logits)[0], np.float64)
        want = sum(lp[t, w] for t, w in enumerate(ids + [2]))
        assert got[k] == pytest.approx(want, abs=1e-4)


def test_rnnlm_get_word_embedding_matches_original(tool_files, tmp_path):
    from kaldi_tpu_torch.core import io as kio
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    mats = []
    for side, tools in (("t", TTOOLS), ("j", JTOOLS)):
        out = str(tmp_path / side)
        assert tools["rnnlm-get-word-embedding"]([p["rnnlm"], out]) in \
            (0, None)
        with kio.open_rxfilename(out) as f:
            assert kio.init_kaldi_input_stream(f)
            mats.append(kio.read_matrix(f))
    np.testing.assert_array_equal(mats[0], mats[1])
    np.testing.assert_array_equal(mats[0], tool_files[1][0]["embed"][
        "embedding"])


@pytest.mark.parametrize("name,args", [
    ("lattice-lmrescore-kaldi-rnnlm", ["--lm-scale=0.5", "{big_rnnlm}",
                                       "{words}"]),
    ("lattice-lmrescore-rnnlm", ["--lm-scale=-0.5", "{big_rnnlm}",
                                 "{words}"]),
    ("lattice-lmrescore-kaldi-rnnlm-pruned",
     ["--lattice-compose-beam=4.0", "{arpa}", "{big_rnnlm}", "{words}"])])
def test_rnnlm_lattice_tools_match_original(tool_files, tmp_path, name,
                                            args):
    """The RNNLM lattice rescorers on the task's lattices: the same
    lattices, graph weights within LAT_TOL."""
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    argv = [a.format(**p) for a in args] + [f"ark:{p['lat']}"]
    tout, jout = str(tmp_path / "t"), str(tmp_path / "j")
    assert TTOOLS[name](["--device=cpu"] + argv + [f"ark:{tout}"]) in \
        (0, None)
    assert JTOOLS[name](argv + [f"ark:{jout}"]) in (0, None)
    _same_lattices(tout, jout, LAT_TOL)


def test_const_arpa_pair_writes_the_originals_bytes(tool_files, tmp_path):
    """arpa-to-const-arpa and const-arpa-to-arpa give the original's
    files byte for byte, and read_const_arpa the original's model."""
    from kaldi_tpu.cli.tools_bank18 import read_const_arpa as jread
    from kaldi_tpu_torch.cli.tools_const_arpa import read_const_arpa
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    files = {}
    for side, tools in (("t", TTOOLS), ("j", JTOOLS)):
        const, back = str(tmp_path / f"{side}.const"), str(
            tmp_path / f"{side}.arpa")
        assert tools["arpa-to-const-arpa"]([p["arpa"], const]) in (0, None)
        assert tools["const-arpa-to-arpa"]([const, back]) in (0, None)
        files[side] = (open(const, "rb").read(), open(back, "rb").read())
    assert files["t"] == files["j"]
    got, want = read_const_arpa(str(tmp_path / "t.const")), \
        jread(str(tmp_path / "j.const"))
    assert got.ngrams == want.ngrams and len(got.ngrams) == 3


def test_lmrescore_const_arpa_reads_a_const_arpa_file(tool_files, tmp_path):
    """arpa-to-const-arpa → lattice-lmrescore-const-arpa (the original
    fails on the binary file): the lattices of the ARPA text, by the
    port's tool and the original's, weights within the const file's
    float32 rounding."""
    p = tool_files[0]
    TTOOLS, JTOOLS = _tools()
    const = str(tmp_path / "lm.const")
    assert TTOOLS["arpa-to-const-arpa"]([p["arpa"], const]) in (0, None)
    outs = {}
    for tag, tools, lm in (("const", TTOOLS, const), ("text", TTOOLS,
                                                       p["arpa"]),
                           ("jax", JTOOLS, p["arpa"])):
        out = str(tmp_path / tag)
        assert tools["lattice-lmrescore-const-arpa"](
            ["--lm-scale=-1.0", lm, p["words"], f"ark:{p['lat']}",
             f"ark:{out}"]) in (0, None)
        outs[tag] = out
    _same_lattices(outs["const"], outs["text"], 1e-4)
    _same_lattices(outs["text"], outs["jax"], 1e-5)
    with pytest.raises(UnicodeDecodeError):
        JTOOLS["lattice-lmrescore-const-arpa"](
            [const, p["words"], f"ark:{p['lat']}",
             f"ark:{tmp_path / 'fails'}"])
