"""The port's chain supervision (kaldi_tpu_torch/am/chain_supervision.py)
against the JAX package's am/chain_supervision.py.

Mirrors the 14 tests of tests/test_chain_supervision.py: each checks the
same property on the port and holds the port to the JAX package on the
same seeded inputs.  Each side builds its FSAs, lattices, den graphs and
egs with its own package.  Bars: host arrays exactly; the numerator's
log-prob at rtol 1e-5 / atol 1e-5 and its gradient (against jax.grad) at
rtol 1e-4 / atol 1e-5; trainer steps within 1e-4 of each tensor's
largest entry (tests/test_torch_chain_train.py's bar).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import chain as jc
from kaldi_tpu.am import chain_supervision as js
from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.am.transitions import TransitionModel as JTm
from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
from kaldi_tpu.lattice import lattice as jlat
from kaldi_tpu.pipelines import chain as jpc
from kaldi_tpu_torch.am import chain as tc
from kaldi_tpu_torch.am import chain_supervision as ts
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.am.topology import HmmTopology as TTopo
from kaldi_tpu_torch.am.transitions import TransitionModel as TTm
from kaldi_tpu_torch.am.tree import MonophoneContextDependency as TMono
from kaldi_tpu_torch.lattice import lattice as tlat
from kaldi_tpu_torch.pipelines import chain as tpc

torch.set_num_threads(1)

PHONES = [1, 2, 3]
DEN_SEQS = [[1, 2, 3], [3, 2, 1]]
# "unbounded": a tolerance past every boundary window (free boundaries)
TOLS = (0, 1, 10 ** 6)
SUP_KEYS = ("src", "dst", "entry_pdf", "self_pdf", "weight", "self_w",
            "final_w", "bt", "start", "final", "num_frames", "num_states",
            "n_arcs", "n_states", "mid_start", "mid_end")


class Side:
    """One package's topology, tree, transition model and pdf maps."""

    def __init__(self, topo_cls, mono_cls, tm_cls, sup_mod, lat_mod,
                 chain_mod):
        self.topo = topo_cls.chain(PHONES)
        self.tree = mono_cls(PHONES, self.topo)
        self.tm = tm_cls(self.topo, self.tree)
        self.sup, self.lat, self.chain = sup_mod, lat_mod, chain_mod
        self.fwd_tid, self.self_tid = {}, {}
        for tid in range(1, self.tm.num_transition_ids + 1):
            ph = self.tm.transition_id_to_phone(tid)
            (self.self_tid if self.tm.is_self_loop(tid)
             else self.fwd_tid).setdefault(ph, tid)

    def pdf(self, phone, is_entry):
        window = [0] * self.tree.context_width
        window[self.tree.central_position] = phone
        st = self.topo.topology_for_phone(phone)[0]
        return self.tree.compute(window, st.forward_pdf_class if is_entry
                                 else st.self_loop_pdf_class)

    def e_of(self, p):
        return self.pdf(p, True)

    def s_of(self, p):
        return self.pdf(p, False)

    def runs(self, paths, weights, T):
        return self.sup.supervision_from_phone_runs(
            paths, weights, self.e_of, self.s_of, T)

    def tids(self, path):
        out = []
        for ph, dur in path:
            out.extend([self.fwd_tid[ph]] + [self.self_tid[ph]] * (dur - 1))
        return tuple(out)

    def lattice(self, alts):
        """A CompactLattice of one word arc per (path, graph cost)."""
        clat = self.lat.CompactLattice()
        s0, s1 = clat.add_state(), clat.add_state()
        clat.start = s0
        for path, cost in alts:
            clat.arcs[s0].append(self.lat.CompactArc(
                1, cost, 0.0, self.tids(path), s1))
        clat.finals[s1] = (0.0, 0.0, ())
        return clat

    def den(self, seqs=DEN_SEQS, **kw):
        return self.chain.make_denominator_graph(seqs, self.tree, self.topo,
                                                 **kw)


J = Side(JTopo, JMono, JTm, js, jlat, jc)
T = Side(TTopo, TMono, TTm, ts, tlat, tc)
P = T.tree.num_pdfs


def _scores(rng, B, T_, P_=P):
    return rng.standard_normal((B, T_, P_)).astype(np.float32)


def _same_fsa(got, want):
    for f in ("src", "dst", "entry_pdf", "self_pdf", "weight", "bt",
              "final", "phone", "self_w", "final_w"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("start", "num_frames", "mid_start", "mid_end"):
        assert getattr(got, f) == getattr(want, f), f


def _same_sup(got, want):
    assert set(got) == set(want) == set(SUP_KEYS)
    for k in SUP_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _num(scores, sup, tol):
    """The port's log-prob and gradient (sum over the batch) on the CPU,
    and the JAX package's."""
    s = torch.tensor(scores, requires_grad=True)
    tv = ts.numerator_fsa_logprob(s, ts.sup_to_device(sup, "cpu"), tol)
    tv.sum().backward()
    jv, jg = jax.value_and_grad(
        lambda x: js.numerator_fsa_logprob(x, sup, tol).sum())(
            jnp.asarray(scores))
    jvals = np.asarray(js.numerator_fsa_logprob(jnp.asarray(scores), sup,
                                                tol))
    return tv.detach().numpy(), s.grad.numpy(), jvals, np.asarray(jg)


def _held(scores, sup, tol):
    """The port's log-prob and gradient, held to the JAX package's."""
    tv, tg, jv, jg = _num(scores, sup, tol)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5)
    return tv, tg


def _ali_from_path(path):
    pdfs = []
    for ph, dur in path:
        pdfs.append(T.e_of(ph))
        pdfs.extend([T.s_of(ph)] * (dur - 1))
    return np.asarray(pdfs, np.int32)


def _fixed(scores, ali):
    return tc.numerator_logprob(torch.from_numpy(scores),
                                torch.from_numpy(ali),
                                torch.ones(ali.shape, dtype=torch.bool))


def _enumerate(scores, segs, T_):
    """Brute-force logsumexp over every monotone alignment of segs."""
    vals = []
    for cut in itertools.combinations(range(1, T_), len(segs) - 1):
        bounds = [0] + list(cut) + [T_]
        tot = 0.0
        for k, ph in enumerate(segs):
            b, e = bounds[k], bounds[k + 1]
            tot += scores[b, T.e_of(ph)] + sum(
                scores[t, T.s_of(ph)] for t in range(b + 1, e))
        vals.append(tot)
    return np.logaddexp.reduce(vals)


def test_single_path_tolerance0_equals_fixed_alignment():
    rng = np.random.default_rng(0)
    T_ = 12
    path = [(1, 4), (2, 5), (3, 3)]
    fsa = T.runs([path], [0.0], T_)
    _same_fsa(fsa, J.runs([path], [0.0], T_))
    sup = ts.pack_supervisions([fsa])
    scores = _scores(rng, 1, T_)
    got, _ = _held(scores, sup, 0)
    ref = _fixed(scores, _ali_from_path(path)[None]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_union_equals_logsumexp_of_paths():
    rng = np.random.default_rng(1)
    T_ = 10
    paths = [[(1, 3), (2, 7)], [(1, 5), (3, 5)], [(2, 10)]]
    ws = [-0.3, -1.1, -2.0]
    union = T.runs(paths, ws, T_)
    _same_fsa(union, J.runs(paths, ws, T_))
    scores = _scores(rng, 1, T_)
    got, _ = _held(scores, ts.pack_supervisions([union]), 0)
    singles = [_num(scores, ts.pack_supervisions([T.runs([p], [w], T_)]),
                    0)[0][0] for p, w in zip(paths, ws)]
    np.testing.assert_allclose(got[0], np.logaddexp.reduce(singles),
                               atol=1e-4)


def test_large_tolerance_equals_free_boundary_enumeration():
    """tolerance ≥ T = free boundary placement: the FSA forward equals
    the brute-force logsumexp over every duration composition."""
    rng = np.random.default_rng(2)
    T_ = 9
    path = [(2, 3), (1, 3), (3, 3)]
    fsa = T.runs([path], [0.0], T_)
    scores = _scores(rng, 1, T_)
    got, _ = _held(scores, ts.pack_supervisions([fsa]), T_)
    np.testing.assert_allclose(
        got[0], _enumerate(scores[0], [ph for ph, _ in path], T_), atol=1e-3)


def test_tolerance_widens_mass_monotonically():
    rng = np.random.default_rng(3)
    T_ = 12
    path = [(1, 4), (2, 4), (3, 4)]
    sup = ts.pack_supervisions([T.runs([path], [0.0], T_)])
    scores = _scores(rng, 1, T_)
    vals = [float(_held(scores, sup, t)[0][0]) for t in (0, 1, 2, 4)]
    assert all(b >= a - 1e-5 for a, b in zip(vals, vals[1:]))
    assert vals[-1] > vals[0]       # tolerance really adds paths


def test_batch_padding_independent():
    """Batched forward == per-item forwards despite shape padding, and
    the batched forward equals the JAX package's."""
    rng = np.random.default_rng(4)
    paths = [[(1, 4), (2, 4)], [(3, 5), (1, 5), (2, 2)]]
    Ts = [8, 12]
    fsas = [T.runs([p], [0.0], t) for p, t in zip(paths, Ts)]
    sup = ts.pack_supervisions(fsas)
    _same_sup(sup, js.pack_supervisions(
        [J.runs([p], [0.0], t) for p, t in zip(paths, Ts)]))
    scores = _scores(rng, 2, max(Ts))
    got, _ = _held(scores, sup, 1)
    for b in (0, 1):
        solo = _num(scores[b:b + 1, :Ts[b]],
                    ts.pack_supervisions([fsas[b]]), 1)[0]
        np.testing.assert_allclose(got[b], solo[0], atol=1e-4)


def test_supervision_from_lattice_matches_paths():
    """A two-alternative CompactLattice (same word, two alignments)
    builds the same numerator as the explicit path union, and the same
    FSA as the JAX package's builder on its own lattice."""
    pa = [(1, 9), (2, 9)]
    pb = [(1, 6), (2, 12)]
    alts = [(pa, 0.5), (pb, 1.5)]
    fsa = ts.supervision_from_lattice(T.lattice(alts), T.tm, T.e_of, T.s_of,
                                      subsample=3)
    _same_fsa(fsa, js.supervision_from_lattice(J.lattice(alts), J.tm,
                                               J.e_of, J.s_of, subsample=3))
    assert fsa.num_frames == 6
    rng = np.random.default_rng(5)
    scores = _scores(rng, 1, 6)
    got, _ = _held(scores, ts.pack_supervisions([fsa]), 0)
    ra = _num(scores, ts.pack_supervisions(
        [T.runs([[(1, 3), (2, 3)]], [-0.5], 6)]), 0)[0][0]
    rb = _num(scores, ts.pack_supervisions(
        [T.runs([[(1, 2), (2, 4)]], [-1.5], 6)]), 0)[0][0]
    np.testing.assert_allclose(got[0], np.logaddexp(ra, rb), atol=1e-4)


# -- egs and the trainer ----------------------------------------------------

EG_FIELDS = ("feats", "pdf_ali", "mask")
D = 5
TCFG = dict(feat_dim=D, hidden_dim=12, bottleneck_dim=6, num_layers=2,
            frame_subsampling_factor=3)


def _same_egs(teg, jeg):
    for f in EG_FIELDS:
        np.testing.assert_array_equal(getattr(teg, f), getattr(jeg, f),
                                      err_msg=f)
    assert jeg.entry_pdf is None and teg.entry_pdf is None
    _same_sup(teg.sup, jeg.sup)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _step_equals_jax(teg, jeg, jden, tden, tol):
    """One AdamW step of each trainer from the same weights on the egs'
    first batch: loss, objf/num/den and every parameter after it."""
    B = min(4, teg.feats.shape[0])
    tcfg = dict(num_epochs=1, batch_size=B, learning_rate=5e-3,
                total_steps=10, supervision_tolerance=tol)
    jt = jpc.ChainTrainer(JCfg(num_pdfs=P, **TCFG), jden,
                          jpc.ChainTrainConfig(**tcfg))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jt.params))
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    tt = tpc.ChainTrainer(ttdnn.TdnnConfig(num_pdfs=P, **TCFG), tden,
                          tpc.ChainTrainConfig(**tcfg), device="cpu")
    tt.model.load_state_dict(ttdnn.params_from_flax(
        {"params": params, "batch_stats": jax.tree_util.tree_map(
            np.asarray, dict(jt.batch_stats))}))
    idx = np.arange(B)
    sup = {k: jnp.asarray(v[idx]) for k, v in jeg.sup.items()}
    (jt.params, jt.batch_stats, jt.opt_state, jl, jd) = jt._step(
        jt.params, jt.batch_stats, jt.opt_state,
        jnp.asarray(jeg.feats[idx]), jnp.asarray(jeg.pdf_ali[idx]),
        jnp.asarray(jeg.mask[idx]), None, sup)
    args = tt.batches(teg, idx)
    assert args[3] is None and args[4] is not None   # the FSA numerator
    tl, td = tt._step(*args)
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    for k in ("objf", "num", "den"):
        assert float(td[k]) == pytest.approx(float(jd[k]), rel=1e-4,
                                             abs=1e-5), k
    back = ttdnn.params_to_flax(tt.model.state_dict())["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jt.params)):
        got = back
        for p in path:
            got = got[p.key]
        assert _rel(got, leaf) < 1e-4, path
    return tt


def _lattice_feats(rng, paths, proto):
    feats = {}
    for u, (pa, _) in paths.items():
        fs = []
        for ph, dur in pa:
            fs.extend([proto[ph] + 0.2 * rng.standard_normal(D)
                       for _ in range(dur)])
        feats[u] = np.asarray(fs, np.float32)
    return feats


def test_make_chain_egs_from_lattices_and_trainer():
    """Alignment lattices → egs with packed supervision (equal to the JAX
    package's) → one ChainTrainer step equal to the JAX trainer's, then
    the port's trainer learns."""
    rng = np.random.default_rng(9)
    paths = {"u0": ([(1, 9), (2, 9), (3, 9)], [(1, 12), (2, 6), (3, 9)]),
             "u1": ([(3, 9), (2, 9), (1, 9)], [(3, 6), (2, 12), (1, 9)])}
    proto = {p: rng.standard_normal(D) for p in PHONES}
    feats = _lattice_feats(rng, paths, proto)
    teg = ts.make_chain_egs_from_lattices(
        feats, {u: T.lattice([(pa, 0.0), (pb, 0.7)])
                for u, (pa, pb) in paths.items()}, T.tm, T.tree, T.topo,
        subsample=3)
    jeg = js.make_chain_egs_from_lattices(
        feats, {u: J.lattice([(pa, 0.0), (pb, 0.7)])
                for u, (pa, pb) in paths.items()}, J.tm, J.tree, J.topo,
        subsample=3)
    _same_egs(teg, jeg)
    assert teg.feats.shape[1] == teg.mask.shape[1] * 3
    tt = _step_equals_jax(teg, jeg, J.den(), T.den(), tol=1)
    tt.cfg.num_epochs = 25
    tt.cfg.batch_size = 2
    out = tt.train(teg, log_every=1000)
    assert np.isfinite(out["loss"])
    assert out["objf"] > -5.0


@pytest.mark.parametrize("c0,c1", [(0, 8), (8, 16), (4, 12), (0, 16)])
def test_chunked_supervision_matches_alignment_slices(c0, c1):
    """chunk_supervision on a single-path FSA at tolerance 0 equals the
    JAX package's chunk, and its numerator equals the fixed-alignment
    numerator of the chunk's pdf slice (mid-phone starts emit the self
    pdf)."""
    rng = np.random.default_rng(31)
    T_ = 16
    path = [(1, 5), (2, 6), (3, 5)]
    fsa = T.runs([path], [0.0], T_)
    ck = ts.chunk_supervision(fsa, c0, c1)
    _same_fsa(ck, js.chunk_supervision(J.runs([path], [0.0], T_), c0, c1))
    assert ck.mid_start == (c0 > 0) and ck.mid_end == (c1 < T_)
    scores = _scores(rng, 1, T_)
    got, _ = _held(np.ascontiguousarray(scores[:, c0:c1]),
                   ts.pack_supervisions([ck]), 0)
    ali = _ali_from_path(path)
    ref = _fixed(np.ascontiguousarray(scores[:, c0:c1]), ali[None, c0:c1])
    assert float(got[0]) == pytest.approx(float(ref[0]), abs=1e-3)


def _single_lattice(side, runs):
    return side.lattice([(runs, 0.0)])


def test_make_chunked_egs_from_lattices():
    """chunk_size cuts utterances into fixed chunks with the den's
    normalization weights, equal to the JAX package's; a trainer step on
    them equals the JAX trainer's."""
    rng = np.random.default_rng(33)
    runs = {"u0": [(1, 12), (2, 12), (3, 12)],
            "u1": [(3, 12), (2, 15), (1, 9)]}
    feats = {u: rng.standard_normal(
        (sum(d for _, d in r) * 3, D)).astype(np.float32)
        for u, r in runs.items()}
    jden, tden = J.den(), T.den()
    teg = ts.make_chain_egs_from_lattices(
        feats, {u: _single_lattice(T, r) for u, r in runs.items()},
        T.tm, T.tree, T.topo, subsample=3, den=tden, chunk_size=6)
    jeg = js.make_chain_egs_from_lattices(
        feats, {u: _single_lattice(J, r) for u, r in runs.items()},
        J.tm, J.tree, J.topo, subsample=3, den=jden, chunk_size=6)
    _same_egs(teg, jeg)
    # 12 subsampled frames per utterance → 2 chunks each
    assert teg.feats.shape[0] == 4
    assert teg.mask.shape[1] == 6
    assert teg.sup["mid_start"].sum() == 2
    _step_equals_jax(teg, jeg, jden, tden, tol=1)


@pytest.mark.parametrize("tol", TOLS)
def test_fsa_numerator_gradient_finite_difference(tol):
    """∂logprob/∂scores from autograd equals jax.grad and central finite
    differences; the gradient is a posterior: rows sum to 1."""
    rng = np.random.default_rng(21)
    T_ = 8
    paths = [[(1, 3), (2, 5)], [(1, 5), (3, 3)]]
    sup = ts.pack_supervisions([T.runs(paths, [-0.2, -0.9], T_)])
    scores = _scores(rng, 1, T_)
    _, g = _held(scores, sup, tol)
    np.testing.assert_allclose(g[0].sum(axis=1), 1.0, atol=1e-4)
    eps = 1e-3
    d = ts.sup_to_device(sup, "cpu")
    s64 = torch.from_numpy(scores).double()
    for (t, p) in [(0, 1), (3, 2), (7, 0), (5, 4 % P)]:
        e = torch.zeros_like(s64)
        e[0, t, p] = eps
        fd = float(ts.numerator_fsa_logprob(s64 + e, d, tol)[0]
                   - ts.numerator_fsa_logprob(s64 - e, d, tol)[0]) / (2 * eps)
        assert fd == pytest.approx(float(g[0, t, p]), abs=2e-3)


@pytest.mark.parametrize("tol", TOLS)
def test_numerator_with_chunks_and_padding_matches_jax(tol):
    """A batch of a whole-utterance union, a mid-utterance chunk of it
    (mid_start and mid_end), a short one-path FSA (padded in arcs,
    states and frames) and a normalization-weighted FSA: values and
    gradients against the JAX package."""
    rng = np.random.default_rng(41)
    union = [[(1, 3), (2, 5), (3, 4)], [(1, 5), (3, 3), (2, 4)]]
    whole = T.runs(union, [0.0, -0.4], 12)
    fsas = [whole, ts.chunk_supervision(whole, 3, 10),
            T.runs([[(2, 4), (1, 3)]], [0.0], 7),
            ts.add_normalization_weights(
                T.runs(union, [0.0, 0.0], 12), T.den(order=2))]
    sup = ts.pack_supervisions(fsas)
    assert sup["mid_start"].tolist() == [False, True, False, False]
    _same_sup(sup, js.pack_supervisions(
        [js.SupervisionFsa(**{k: getattr(f, k) for k in (
            "src", "dst", "entry_pdf", "self_pdf", "weight", "bt", "start",
            "final", "num_frames", "phone", "self_w", "final_w",
            "mid_start", "mid_end")}) for f in fsas]))
    _held(_scores(rng, 4, 12), sup, tol)


def test_normalization_weights_bound_numerator():
    """add_normalization_weights equals the JAX package's on the same
    monophone den; with the weights composed in, num ≤ den for any
    scores, and the weights subtract mass."""
    seqs = [[1, 2, 3], [3, 2, 1], [2, 1, 3], [1, 3, 2]]
    jden, tden = J.den(seqs, order=2), T.den(seqs, order=2)
    T_ = 10
    paths = [[(1, 3), (2, 4), (3, 3)], [(1, 4), (3, 3), (2, 3)]]
    raw = T.runs(paths, [0.0, 0.0], T_)
    norm = ts.add_normalization_weights(raw, tden)
    _same_fsa(norm, js.add_normalization_weights(
        J.runs(paths, [0.0, 0.0], T_), jden))
    assert norm.self_w is not None and (norm.self_w < 0).all()
    sup_raw = ts.pack_supervisions([raw])
    sup_norm = ts.pack_supervisions([norm])
    rng = np.random.default_rng(11)
    for trial in range(5):
        scores = _scores(rng, 1, T_)
        num = float(_held(scores, sup_norm, 1)[0][0])
        d = float(tc.denominator_logprob(
            tden, torch.from_numpy(scores),
            mask=torch.ones((1, T_), dtype=torch.bool))[0])
        assert num <= d + 1e-3, f"trial {trial}: num {num} > den {d}"
        assert num < float(_num(scores, sup_raw, 1)[0][0])


def test_chain_training_with_lattice_supervision():
    """Gradients flow through the FSA numerator and the LF-MMI objective
    improves under Adam; the first loss and gradient equal the JAX
    package's chain_objf(num_fsa=)."""
    tden, jden = T.den(), J.den()
    rng = np.random.default_rng(6)
    T_ = 12
    paths = [[[(1, 4), (2, 4), (3, 4)], [(1, 6), (2, 3), (3, 3)]],
             [[(3, 4), (2, 4), (1, 4)]]]
    sup = ts.pack_supervisions([T.runs(ps, [0.0] * len(ps), T_)
                                for ps in paths])
    feats = torch.from_numpy(rng.standard_normal((2, T_, 4))
                             .astype(np.float32))
    mask = torch.ones((2, T_), dtype=torch.bool)
    W = torch.zeros((4, P), requires_grad=True)
    dsup = ts.sup_to_device(sup, "cpu")
    opts = tc.ChainTrainingOptions(l2_regularize=0.0,
                                   leaky_hmm_coefficient=0.0)
    jl, jg = jax.value_and_grad(lambda w: jc.chain_objf(
        jden, jnp.asarray(feats.numpy()) @ w, None,
        jnp.ones((2, T_), bool), jc.ChainTrainingOptions(
            l2_regularize=0.0, leaky_hmm_coefficient=0.0),
        num_fsa=(sup, 1))[0])(jnp.zeros((4, P), jnp.float32))
    opt = torch.optim.Adam([W], lr=0.1)
    losses = []
    for i in range(30):
        loss, _ = tc.chain_objf(tden, feats @ W, None, mask, opts,
                                num_fsa=(dsup, 1))
        opt.zero_grad()
        loss.backward()
        if i == 0:
            assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
            np.testing.assert_allclose(W.grad.numpy(), np.asarray(jg),
                                       rtol=1e-4, atol=1e-5)
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.1


def test_supervision_from_text_free_boundaries():
    """e2e supervision (text only, no durations), equal to the JAX
    package's, at tolerance >= T equals the brute-force logsumexp over
    every monotone alignment."""
    rng = np.random.default_rng(31)
    T_ = 8
    segs = [2, 1, 2]          # a repeated phone is fine: distinct arcs
    fsa = ts.supervision_from_text(segs, T.e_of, T.s_of, T_)
    _same_fsa(fsa, js.supervision_from_text(segs, J.e_of, J.s_of, T_))
    scores = _scores(rng, 1, T_)
    got, _ = _held(scores, ts.pack_supervisions([fsa]), T_)
    np.testing.assert_allclose(got[0], _enumerate(scores[0], segs, T_),
                               atol=1e-3)


def test_make_chain_egs_e2e_and_trainer():
    """Flat-start end-to-end chain: egs from text only (equal to the JAX
    package's); one step equal to the JAX trainer's; training with free
    boundaries learns separable data."""
    jden, tden = J.den(), T.den()
    rng = np.random.default_rng(12)
    proto = {p: rng.standard_normal(D) for p in PHONES}
    texts = {"u0": [1, 2, 3], "u1": [3, 2, 1]}
    true_durs = {"u0": [9, 12, 9], "u1": [12, 9, 9]}
    feats = {}
    for u, seq in texts.items():
        fs = []
        for ph, dur in zip(seq, true_durs[u]):
            fs.extend([proto[ph] + 0.2 * rng.standard_normal(D)
                       for _ in range(dur)])
        feats[u] = np.asarray(fs, np.float32)
    teg = ts.make_chain_egs_e2e(feats, texts, T.tree, T.topo, subsample=3,
                                den=tden)
    jeg = js.make_chain_egs_e2e(feats, texts, J.tree, J.topo, subsample=3,
                                den=jden)
    _same_egs(teg, jeg)
    T_sub = teg.mask.shape[1]
    tt = _step_equals_jax(teg, jeg, jden, tden, tol=T_sub)
    tt.cfg.num_epochs = 30
    tt.cfg.batch_size = 2
    out = tt.train(teg, log_every=1000)
    assert np.isfinite(out["loss"])
    sc = tt.scores_fn()(feats["u0"][None])[0].numpy()     # (T_sub, P)
    # the middle of the first segment (subsampled frames 0..2) is phone 1
    assert sc[1].argmax() in (T.e_of(1), T.s_of(1))
