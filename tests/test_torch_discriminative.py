"""The port's sequence-training objectives and fine-tuning
(kaldi_tpu_torch/am/discriminative.py, pipelines/discriminative.py)
against the JAX package's, mirroring every test of
tests/test_discriminative.py on the same seeded inputs.

Each lattice is built twice from the same draws, once from each
package's Lattice class.  Bars: the host copies (dense lattices,
ε-removal, frame accuracies) equal; ``lattice_logz``, ``mmi_objf`` and
``smbr_objf`` within 1e-5 relative of the JAX value; their gradients
with respect to the scores, and the den occupancies, within 1e-5
absolute; ``discriminative_finetune``'s objective history within 1e-4
over 2 epochs at the original test's widths (hidden 16, 2 layers), the
port's trainer holding the JAX trainer's trained weights.  The
original's own properties (brute-force path sums, posteriors, ascent)
are checked on the port's side too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import discriminative as jd
from kaldi_tpu.lattice.lattice import Lattice as JLattice
from kaldi_tpu.lattice.lattice import LatticeArc as JArc
from kaldi_tpu_torch.am import discriminative as td
from kaldi_tpu_torch.lattice.lattice import Lattice as TLattice
from kaldi_tpu_torch.lattice.lattice import LatticeArc as TArc

torch.set_num_threads(1)

REL = 1e-5
GRAD_ABS = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_confusion_lattice(cls, arc, T=4, npdf=3, width=2, seed=1):
    """A time-synchronous sausage: `width` parallel arcs per frame with
    random pdfs and graph costs (the original's fixture, drawn from
    ``seed`` for either package's classes)."""
    rng = np.random.default_rng(seed)
    lat = cls()
    states = [lat.add_state() for _ in range(T + 1)]
    lat.start = states[0]
    for t in range(T):
        for _ in range(width):
            pdf = int(rng.integers(npdf))
            gc = float(rng.uniform(0, 2))
            lat.arcs[states[t]].append(arc(pdf + 1, 0, gc, 0.0,
                                           states[t + 1]))
    lat.set_final(states[T], 0.5, 0.0)
    return lat


def both_lattices(T, P, width, seed):
    return (make_confusion_lattice(JLattice, JArc, T, P, width, seed),
            make_confusion_lattice(TLattice, TArc, T, P, width, seed))


def identity_tid_to_pdf(npdf):
    return np.concatenate([[0], np.arange(npdf)]).astype(np.int32)


def dense_pair(T, P, width, seed):
    jl, tl = both_lattices(T, P, width, seed)
    t2p = identity_tid_to_pdf(P)
    jdl, tdl = jd.lattice_to_dense(jl, t2p), td.lattice_to_dense(tl, t2p)
    for f in ("src", "dst", "pdf", "w", "mask", "final", "num_states"):
        np.testing.assert_array_equal(getattr(tdl, f), getattr(jdl, f), f)
    return jl, tl, jdl, tdl


def brute_force_paths(lat, tid_to_pdf):
    paths = []

    def walk(s, pdfs, w):
        if s in lat.finals:
            gc, ac = lat.finals[s]
            paths.append((list(pdfs), w - gc - ac))
        for a in lat.arcs[s]:
            walk(a.nextstate, pdfs + [int(tid_to_pdf[a.ilabel])],
                 w - a.graph_cost - a.acoustic_cost)

    walk(lat.start, [], 0.0)
    return paths


def value_and_grad(fn, scores):
    s = torch.tensor(scores, requires_grad=True)
    v = fn(s)
    g, = torch.autograd.grad(v, s)
    return float(v.detach()), g.numpy()


def close(got, want, rel=REL):
    assert abs(got - want) <= rel * max(abs(want), 1e-30), (got, want)


def test_logz_matches_jax_and_brute_force(rng):
    T, P = 4, 3
    jl, tl, jdl, tdl = dense_pair(T, P, 2, 1)
    scores = rng.standard_normal((T, P)).astype(np.float32)
    kappa = 0.7
    want, jg = jax.value_and_grad(
        lambda s: jd.lattice_logz(jdl, s, kappa))(jnp.asarray(scores))
    got, tg = value_and_grad(lambda s: td.lattice_logz(tdl, s, kappa),
                             scores)
    close(got, float(want))
    np.testing.assert_allclose(tg, np.asarray(jg), atol=GRAD_ABS)
    paths = brute_force_paths(tl, identity_tid_to_pdf(P))
    vals = [w + kappa * sum(float(scores[t, p]) for t, p in enumerate(pp))
            for pp, w in paths]
    assert got == pytest.approx(float(np.logaddexp.reduce(vals)), abs=1e-4)


def test_occupancies_equal_jax_and_are_posteriors(rng):
    T, P = 3, 3
    jl, tl, jdl, tdl = dense_pair(T, P, 3, 1)
    scores = rng.standard_normal((T, P)).astype(np.float32)
    want = np.asarray(jd.den_occupancies(jdl, jnp.asarray(scores), 1.0))
    got = td.den_occupancies(tdl, torch.tensor(scores), 1.0).numpy()
    np.testing.assert_allclose(got, want, atol=GRAD_ABS)
    paths = brute_force_paths(tl, identity_tid_to_pdf(P))
    vals = np.array([w + sum(float(scores[t, p]) for t, p in enumerate(pp))
                     for pp, w in paths])
    post = np.exp(vals - np.logaddexp.reduce(vals))
    brute = np.zeros((T, P))
    for (pp, _), pr in zip(paths, post):
        for t, p in enumerate(pp):
            brute[t, p] += pr
    np.testing.assert_allclose(got, brute, atol=1e-4)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-4)


def test_smbr_matches_jax_and_brute_force(rng):
    T, P = 4, 3
    jl, tl, jdl, tdl = dense_pair(T, P, 2, 1)
    ref = rng.integers(0, P, T).astype(np.int32)
    acc = td.frame_accuracy(tdl, ref)
    np.testing.assert_array_equal(acc, jd.frame_accuracy(jdl, ref))
    scores = rng.standard_normal((T, P)).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda s: jd.smbr_objf(jdl, s, jnp.asarray(acc), 1.0))(
        jnp.asarray(scores))
    got, tg = value_and_grad(
        lambda s: td.smbr_objf(tdl, s, torch.tensor(acc), 1.0), scores)
    close(got, float(want))
    np.testing.assert_allclose(tg, np.asarray(jg), atol=GRAD_ABS)
    paths = brute_force_paths(tl, identity_tid_to_pdf(P))
    vals = np.array([w + sum(float(scores[t, p]) for t, p in enumerate(pp))
                     for pp, w in paths])
    post = np.exp(vals - np.logaddexp.reduce(vals))
    accs = np.array([sum(1.0 for t, p in enumerate(pp) if p == ref[t])
                     for pp, _ in paths])
    assert got == pytest.approx(float((post * accs).sum()), abs=1e-4)


def test_mmi_gradient_equals_jax_and_signs(rng):
    T, P = 3, 3
    _, _, jdl, tdl = dense_pair(T, P, 3, 1)
    scores = np.zeros((T, P), np.float32)
    num = np.zeros(T, np.int32)
    want, jg = jax.value_and_grad(
        lambda s: jd.mmi_objf(jdl, s, jnp.asarray(num), 1.0))(
        jnp.asarray(scores))
    got, tg = value_and_grad(
        lambda s: td.mmi_objf(tdl, s, torch.tensor(num), 1.0), scores)
    close(got, float(want))
    np.testing.assert_allclose(tg, np.asarray(jg), atol=GRAD_ABS)
    gamma = td.den_occupancies(tdl, torch.tensor(scores), 1.0).numpy()
    np.testing.assert_allclose(tg, np.eye(P)[num] - gamma, atol=1e-4)


def _ascent(objf_j, objf_t, W0, feats, lr, steps):
    """Gradient ascent of a linear scorer on both sides from the same
    start; → (JAX start, JAX end, port start, port end)."""
    g = jax.jit(jax.grad(lambda W: objf_j(jnp.asarray(feats) @ W)))
    Wj = jnp.asarray(W0)
    oj0 = float(objf_j(jnp.asarray(feats) @ Wj))
    for _ in range(steps):
        Wj = Wj + lr * g(Wj)
    oj1 = float(objf_j(jnp.asarray(feats) @ Wj))
    x = torch.tensor(feats)
    Wt = torch.tensor(W0, requires_grad=True)
    ot0 = float(objf_t(x @ Wt).detach())
    for _ in range(steps):
        gt, = torch.autograd.grad(objf_t(x @ Wt), Wt)
        with torch.no_grad():
            Wt += lr * gt
    ot1 = float(objf_t(x @ Wt).detach())
    return oj0, oj1, ot0, ot1


def test_mmi_ascent_equals_jax_and_improves(rng):
    T, P, D = 6, 4, 5
    jl, tl, jdl, tdl = dense_pair(T, P, 3, 1)
    t2p = identity_tid_to_pdf(P)
    num = np.array([int(t2p[tl.arcs[t][int(rng.integers(3))].ilabel])
                    for t in range(T)], np.int32)
    feats = rng.standard_normal((T, D)).astype(np.float32)
    oj0, oj1, ot0, ot1 = _ascent(
        lambda s: jd.mmi_objf(jdl, s, jnp.asarray(num), 1.0),
        lambda s: td.mmi_objf(tdl, s, torch.tensor(num), 1.0),
        np.zeros((D, P), np.float32), feats, 0.3, 100)
    close(ot0, oj0)
    close(ot1, oj1, 1e-4)
    assert ot1 > ot0 + 0.5
    assert ot1 <= 2.0 * T + 0.5 + 1e-3


def test_smbr_ascent_equals_jax_and_raises_accuracy(rng):
    T, P, D = 6, 4, 5
    _, _, jdl, tdl = dense_pair(T, P, 3, 1)
    ref = rng.integers(0, P, T).astype(np.int32)
    acc = td.frame_accuracy(tdl, ref)
    feats = rng.standard_normal((T, D)).astype(np.float32)
    oj0, oj1, ot0, ot1 = _ascent(
        lambda s: jd.smbr_objf(jdl, s, jnp.asarray(acc), 1.0),
        lambda s: td.smbr_objf(tdl, s, torch.tensor(acc), 1.0),
        np.zeros((D, P), np.float32), feats, 0.5, 150)
    close(ot0, oj0)
    close(ot1, oj1, 1e-4)
    assert ot1 > ot0 + 0.2
    assert ot1 <= T + 1e-3


@pytest.mark.parametrize("cls,arc,mod", [(JLattice, JArc, jd),
                                         (TLattice, TArc, td)],
                         ids=["jax", "port"])
def test_dense_rejects_eps_arcs(cls, arc, mod):
    lat = cls()
    s0, s1 = lat.add_state(), lat.add_state()
    lat.start = s0
    lat.arcs[s0].append(arc(0, 0, 0.0, 0.0, s1))
    lat.set_final(s1)
    with pytest.raises(ValueError):
        mod.lattice_to_dense(lat, identity_tid_to_pdf(2))


def _eps_lattice(cls, arc):
    lat = cls()
    s = [lat.add_state() for _ in range(6)]
    lat.start = s[0]
    lat.arcs[s[0]].append(arc(1, 0, 0.3, 0.0, s[1]))
    lat.arcs[s[0]].append(arc(2, 0, 0.7, 0.0, s[2]))
    lat.arcs[s[2]].append(arc(0, 5, 0.2, 0.0, s[1]))  # ε
    lat.arcs[s[1]].append(arc(3, 0, 0.1, 0.0, s[3]))
    lat.arcs[s[3]].append(arc(0, 0, 0.4, 0.0, s[4]))  # ε
    lat.arcs[s[4]].append(arc(0, 0, 0.1, 0.0, s[5]))  # ε chain
    lat.set_final(s[3], 0.6, 0.0)
    lat.set_final(s[5], 0.2, 0.0)
    return lat


def _arcs_finals(lat):
    return ([[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
               a.nextstate) for a in arcs] for arcs in lat.arcs],
            sorted(lat.finals.items()))


def test_eps_removal_equals_jax_and_preserves_path_sums():
    got = td.remove_eps_arcs(_eps_lattice(TLattice, TArc))
    want = jd.remove_eps_arcs(_eps_lattice(JLattice, JArc))
    assert _arcs_finals(got) == _arcs_finals(want)
    assert all(a.ilabel != 0 for arcs in got.arcs for a in arcs)

    def seq_sums(l):
        d = {}

        def walk(s, pdfs, w):
            if s in l.finals:
                gc, ac = l.finals[s]
                d.setdefault(tuple(pdfs), []).append(w - gc - ac)
            for a in l.arcs[s]:
                nxt = pdfs + ([a.ilabel - 1] if a.ilabel else [])
                walk(a.nextstate, nxt, w - a.graph_cost - a.acoustic_cost)

        walk(l.start, [], 0.0)
        return {k: float(np.logaddexp.reduce(v)) for k, v in d.items()}

    g, w = seq_sums(got), seq_sums(_eps_lattice(TLattice, TArc))
    assert set(g) == set(w)
    for k in w:
        assert g[k] == pytest.approx(w[k], abs=1e-6), k


def _yesno_graph(pkg):
    """The original test's YES/NO unigram graph, built by ``pkg``'s own
    graph builders (the port's copies give the same arrays)."""
    import importlib
    topology = importlib.import_module(f"{pkg}.am.topology")
    tree_mod = importlib.import_module(f"{pkg}.am.tree")
    transitions = importlib.import_module(f"{pkg}.am.transitions")
    fst = importlib.import_module(f"{pkg}.fst")
    lex = fst.Lexicon(entries=[("YES", ["Y", "EH", "S"]),
                               ("NO", ["N", "OW"])])
    lang = fst.Lang(lex)
    phones = lang.phone_list()
    topo = topology.HmmTopology.three_state(phones)
    tree = tree_mod.MonophoneContextDependency(phones, topo)
    tm = transitions.TransitionModel(topo, tree)
    arpa = fst.ArpaModel.parse(fst.make_unigram_arpa({"YES": 1.0,
                                                      "NO": 1.0}))
    return tm, fst.mkgraph(lang, tm, fst.arpa_to_fst(arpa, lang.words))


@pytest.fixture(scope="module")
def yesno_decoders():
    from kaldi_tpu.decoder.dense import DenseDecoder as JDec
    from kaldi_tpu.decoder.dense import DenseDecoderConfig as JCfg
    from kaldi_tpu_torch.decoder.dense import DenseDecoder as TDec
    from kaldi_tpu_torch.decoder.dense import DenseDecoderConfig as TCfg
    jtm, jG = _yesno_graph("kaldi_tpu")
    ttm, tG = _yesno_graph("kaldi_tpu_torch")
    np.testing.assert_array_equal(jtm.tid_to_pdf_array, ttm.tid_to_pdf_array)

    def make(scale, lattice_beam):
        return (JDec(jG, jtm.tid_to_pdf_array,
                     JCfg(beam=1e9, acoustic_scale=scale,
                          lattice_beam=lattice_beam)),
                TDec(tG, ttm.tid_to_pdf_array,
                     TCfg(beam=1e9, acoustic_scale=scale,
                          lattice_beam=lattice_beam), device="cpu"))
    return jtm, ttm, make


def test_den_lattice_from_real_decoder(rng, yesno_decoders):
    """Real HCLG decode → ε-removal → dense FB on both sides: equal
    dense lattices, occupancies within the bar (summing to 1 per frame),
    and MMI ascent of the scores equal to the JAX package's."""
    jtm, ttm, make = yesno_decoders
    jdec, tdec = make(1.0, 10.0)
    T, P = 24, jtm.tree.num_pdfs
    ll = rng.standard_normal((T, P)).astype(np.float32)
    jdl = jd.den_lattice_from_decoder(jdec, ll)
    tdl = td.den_lattice_from_decoder(tdec, ll)
    assert tdl.T == T
    for f in ("src", "dst", "pdf", "mask", "final", "num_states"):
        np.testing.assert_array_equal(getattr(tdl, f), getattr(jdl, f), f)
    np.testing.assert_allclose(tdl.w, jdl.w, rtol=1e-6, atol=1e-6)
    gamma = td.den_occupancies(tdl, torch.tensor(ll), 1.0).numpy()
    np.testing.assert_allclose(
        gamma, np.asarray(jd.den_occupancies(jdl, jnp.asarray(ll), 1.0)),
        atol=GRAD_ABS)
    np.testing.assert_allclose(gamma.sum(1), 1.0, atol=1e-3)
    raw, _ = tdec.decode_lattice(ll)
    tids, _, _ = raw.best_path()
    num = ttm.tid_to_pdf_array[np.asarray(tids)]
    gj = jax.jit(jax.grad(lambda s: jd.mmi_objf(jdl, s, jnp.asarray(num),
                                                1.0)))
    sj = jnp.asarray(ll)
    st = torch.tensor(ll, requires_grad=True)
    o0 = float(td.mmi_objf(tdl, st, torch.tensor(num), 1.0).detach())
    for _ in range(30):
        sj = sj + 0.5 * gj(sj)
        gt, = torch.autograd.grad(td.mmi_objf(tdl, st, torch.tensor(num),
                                              1.0), st)
        with torch.no_grad():
            st += 0.5 * gt
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj),
                               atol=1e-4)
    assert float(td.mmi_objf(tdl, st, torch.tensor(num),
                             1.0).detach()) > o0 + 0.5


@pytest.fixture(scope="module")
def finetune_setup(yesno_decoders):
    """The original pipeline test's corpus and xent TDNN (hidden 16, 2
    layers), trained once by the JAX trainer; the port's trainer holds
    its trained weights and priors."""
    from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
    from kaldi_tpu.pipelines.nnet import XentTrainConfig as JXCfg
    from kaldi_tpu.pipelines.nnet import XentTrainer as JXent
    jtm, ttm, make = yesno_decoders
    jdec, tdec = make(0.1, 8.0)
    rng = np.random.default_rng(0)
    P, D, T = jtm.tree.num_pdfs, 6, 36
    proto = rng.standard_normal((P, D)).astype(np.float32) * 2
    feats, alis = {}, {}
    for i in range(3):
        tids, _, _ = jdec.decode(
            rng.standard_normal((T, P)).astype(np.float32))
        ref = jtm.tid_to_pdf_array[np.asarray(tids)]
        alis[f"u{i}"] = ref.astype(np.int32)
        feats[f"u{i}"] = (proto[ref] + 1.0 * rng.standard_normal(
            (T, D))).astype(np.float32)
    cfg = dict(feat_dim=D, num_pdfs=P, hidden_dim=16, bottleneck_dim=8,
               num_layers=2, frame_subsampling_factor=1)
    jtr = JXent(JCfg(**cfg), JXCfg(num_epochs=6, chunk_size=12,
                                   batch_size=4, learning_rate=3e-3))
    jtr.train(feats, alis)
    variables = {"params": jax.tree_util.tree_map(np.asarray, jtr.params),
                 "batch_stats": jax.tree_util.tree_map(
                     np.asarray, dict(jtr.batch_stats))}
    return jtr, variables, cfg, feats, alis, jdec, tdec


def _port_trainer(variables, cfg, log_priors):
    from kaldi_tpu_torch.am.tdnn import TdnnConfig, params_from_flax
    from kaldi_tpu_torch.pipelines.nnet import XentTrainer
    tr = XentTrainer(TdnnConfig(**cfg), device="cpu")
    tr.model.load_state_dict(params_from_flax(variables))
    tr.log_priors = np.asarray(log_priors, np.float32).copy()
    return tr


@pytest.mark.parametrize("criterion", ["smbr", "mmi"])
def test_discriminative_finetune_equals_jax(finetune_setup, criterion):
    """Two epochs of fine-tuning from the same trained xent weights: the
    degs equal, the objective history within 1e-4 of the JAX run's."""
    from kaldi_tpu.pipelines import discriminative as jp
    from kaldi_tpu_torch.pipelines import discriminative as tp
    jtr, variables, cfg, feats, alis, jdec, tdec = finetune_setup
    saved = jtr.params
    try:
        want = jp.discriminative_finetune(
            jtr, jdec, feats, alis,
            jp.DiscriminativeConfig(criterion=criterion, num_epochs=2,
                                    learning_rate=3e-4,
                                    acoustic_scale=0.1))["objf"]
    finally:
        jtr.params = saved
    ttr = _port_trainer(variables, cfg, jtr.log_priors)
    scorer = ttr.loglikes_fn()
    jdegs = jp.make_degs(jdec, {u: np.asarray(jtr.loglikes_fn()(
        jnp.asarray(feats[u]))) for u in feats})
    tdegs = tp.make_degs(tdec, {u: scorer(feats[u]) for u in feats})
    for u in feats:
        for f in ("src", "dst", "pdf", "mask", "final"):
            np.testing.assert_array_equal(getattr(tdegs[u], f),
                                          getattr(jdegs[u], f), f)
    got = tp.discriminative_finetune(
        ttr, tdec, feats, alis,
        tp.DiscriminativeConfig(criterion=criterion, num_epochs=2,
                                learning_rate=3e-4,
                                acoustic_scale=0.1))["objf"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_discriminative_finetune_pipeline(finetune_setup):
    """The original's end-to-end property on the port: six sMBR epochs
    raise the expected accuracy, six MMI epochs the MMI objective."""
    from kaldi_tpu_torch.pipelines import discriminative as tp
    jtr, variables, cfg, feats, alis, jdec, tdec = finetune_setup
    for criterion, margin in (("smbr", 0.01), ("mmi", 0.0)):
        ttr = _port_trainer(variables, cfg, jtr.log_priors)
        hist = tp.discriminative_finetune(
            ttr, tdec, feats, alis,
            tp.DiscriminativeConfig(criterion=criterion, num_epochs=6,
                                    learning_rate=3e-4,
                                    acoustic_scale=0.1))["objf"]
        assert np.isfinite(hist).all()
        assert hist[-1] > hist[0] + margin, (criterion, hist)


def test_lattice_to_moves_once():
    """``lattice_to`` gives int64 index tensors and float32 weights; an
    objective handed a lattice already on the scores' device uses it as
    it is (no copy per call)."""
    _, _, _, tdl = dense_pair(4, 3, 2, 1)
    on = td.lattice_to(tdl, "cpu")
    assert on.src.dtype == torch.int64 and on.w.dtype == torch.float32
    assert td._on(on, torch.zeros(4, 3)) is on
    scores = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    assert float(td.lattice_logz(on, scores)) == pytest.approx(
        float(td.lattice_logz(tdl, scores)), rel=0, abs=0)
