"""The port's chain training (kaldi_tpu_torch/pipelines/chain.py) against
the JAX package's pipelines/chain.py.

Each side builds its den graph and egs with its own package from the
same phone runs and features (the egs must be equal); the port's trainer
starts from the flax trainer's parameters (drawn from numpy, so the
output layer is not zero) through ``params_from_flax``.  Fresh optimizer
states are equal on both sides by construction.  Tolerance: loss,
diagnostics, parameters and batch statistics within 1e-4 of each
tensor's largest entry (float32 in other orders; the NG-SGD estimates go
through two libraries' QR and eigh).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import chain as jc
from kaldi_tpu.am import tree as jtree
from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.am.transitions import TransitionModel as JTm
from kaldi_tpu.pipelines import chain as jpc
from kaldi_tpu_torch.am import chain as tc
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.am import tree as ttree
from kaldi_tpu_torch.am.topology import HmmTopology as TTopo
from kaldi_tpu_torch.am.transitions import TransitionModel as TTm
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.pipelines import chain as tpc
from test_torch_chain_start import port_graph

torch.set_num_threads(1)

PHONES = [1, 2, 3]
SEQS = [[1, 2, 3, 1, 2], [2, 1, 3, 3], [1, 2, 1, 2, 3], [3, 1, 2]]
EGS_FIELDS = ("feats", "pdf_ali", "mask", "entry_pdf", "self_pdf",
              "num_segs", "entry_w", "self_w", "init_w", "final_w")


def _runs(seed=0, n_utts=4, n_phones=12, dim=5):
    rng = np.random.default_rng(seed)
    runs = {f"u{i}": [(int(rng.integers(1, 4)), int(rng.integers(3, 10)))
                      for _ in range(n_phones)] for i in range(n_utts)}
    feats = {u: rng.standard_normal((sum(d for _, d in r), dim))
             .astype(np.float32) for u, r in runs.items()}
    return runs, feats


def _sides(tree_kind="mono", order=2):
    """(topo, tree, den) of each package: the JAX side, then the port.
    The port's den of a biphone tree is the JAX package's graph as the
    port's (its own builder adds utterance-initial states:
    tests/test_torch_chain_start.py)."""
    out = []
    for topo_cls, tree_mod, chain in ((JTopo, jtree, jc),
                                      (TTopo, ttree, tc)):
        topo = topo_cls.chain(PHONES)
        tree = (tree_mod.MonophoneContextDependency(PHONES, topo)
                if tree_kind == "mono"
                else tree_mod.full_biphone_tree(PHONES, topo))
        out.append((topo, tree, chain.make_denominator_graph(
            SEQS, tree, topo, order=order)))
    if tree_kind == "biphone":
        out[1] = out[1][:2] + (port_graph(out[0][2]),)
    return out


@pytest.mark.parametrize("tree_kind", ["mono", "biphone"])
def test_make_chain_egs_equals_jax(tree_kind):
    """Every array, the den's normalization weights included, for a
    monophone and a (2,1) tree: the port's right-context repair changes
    nothing where no right context is read."""
    (jt, jtr, jden), (tt, ttr, tden) = _sides(tree_kind)
    runs, feats = _runs(seed=3)
    jeg = jpc.make_chain_egs(feats, runs, jtr, jt, chunk_size=24,
                             subsample=3, den=jden)
    teg = tpc.make_chain_egs(feats, runs, ttr, tt, chunk_size=24,
                             subsample=3, den=tden)
    for f in EGS_FIELDS:
        np.testing.assert_array_equal(getattr(teg, f), getattr(jeg, f),
                                      err_msg=f)


class _Triphone:
    """A (3,1) tree whose pdf names (left, phone, right, class)."""
    context_width, central_position = 3, 1

    def compute(self, window, cls):
        left, phone, right = window
        return ((left * 5 + phone) * 5 + right) * 2 + cls


def test_triphone_right_context_is_the_next_phone():
    """Under a (3,1) tree the port differs from the original only on the
    last segment of chunks that the utterance continues past, where it
    takes the next phone instance instead of 0."""
    jt, tt = JTopo.chain(PHONES), TTopo.chain(PHONES)
    runs, feats = _runs(seed=4, n_utts=3, n_phones=14)
    tree = _Triphone()
    jeg = jpc.make_chain_egs(feats, runs, tree, jt, chunk_size=24,
                             subsample=3)
    teg = tpc.make_chain_egs(feats, runs, tree, tt, chunk_size=24,
                             subsample=3)
    np.testing.assert_array_equal(teg.pdf_ali, jeg.pdf_ali)
    np.testing.assert_array_equal(teg.num_segs, jeg.num_segs)
    changed = 0
    for i, n in enumerate(teg.num_segs):
        for name in ("entry_pdf", "self_pdf"):
            t, j = getattr(teg, name)[i], getattr(jeg, name)[i]
            np.testing.assert_array_equal(t[:n - 1], j[:n - 1])
            np.testing.assert_array_equal(t[n:], j[n:])
            right_t, right_j = (t[n - 1] // 2) % 5, (j[n - 1] // 2) % 5
            assert right_j == 0 and t[n - 1] - j[n - 1] == 2 * right_t
            changed += right_t != 0
    # every utterance's chunks but the last continue into a next phone
    assert changed >= 3
    # and the last segment's right context is the utterance's next phone
    sub = []
    for ph, d in runs["u0"]:
        sub.extend([ph] * d)
    sub = [sub[min(3 * t + 1, len(sub) - 1)] for t in range(len(sub) // 3)]
    last = sub[7]                         # chunk 0 covers sub-frames 0-7
    nxt = next(p for p in sub[8:] if p != last)
    assert (teg.entry_pdf[0][teg.num_segs[0] - 1] // 2) % 5 == nxt


def test_phone_alignment_runs_matches_jax():
    topo_j, topo_t = JTopo.chain(PHONES), TTopo.chain(PHONES)
    jtm = JTm(topo_j, jtree.MonophoneContextDependency(PHONES, topo_j))
    ttm = TTm(topo_t, ttree.MonophoneContextDependency(PHONES, topo_t))
    rng = np.random.default_rng(0)
    tids = [int(t) for t in rng.integers(1, jtm.num_transition_ids + 1, 40)]
    assert tpc.phone_alignment_runs(ttm, tids) == \
        jpc.phone_alignment_runs(jtm, tids)


CFG = dict(feat_dim=5, hidden_dim=16, bottleneck_dim=8, num_layers=3,
           frame_subsampling_factor=3)


def _trainers(optimizer, **cfg_kw):
    """A flax trainer with numpy-drawn parameters and the port's trainer
    holding the same ones."""
    (_, jtr, jden), (_, ttr, tden) = _sides()
    tcfg = dict(num_epochs=1, batch_size=4, learning_rate=1e-2,
                total_steps=10, optimizer=optimizer)
    tcfg.update(cfg_kw)
    jt = jpc.ChainTrainer(JCfg(num_pdfs=jtr.num_pdfs, **CFG), jden,
                          jpc.ChainTrainConfig(**tcfg))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jt.params))
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    tt = tpc.ChainTrainer(ttdnn.TdnnConfig(num_pdfs=ttr.num_pdfs, **CFG),
                          tden, tpc.ChainTrainConfig(**tcfg), device="cpu")
    tt.model.load_state_dict(ttdnn.params_from_flax(
        {"params": params, "batch_stats": jax.tree_util.tree_map(
            np.asarray, dict(jt.batch_stats))}))
    return jt, tt


def _egs():
    (jt, jtr, jden), (tt, ttr, tden) = _sides()
    runs, feats = _runs()
    return (jpc.make_chain_egs(feats, runs, jtr, jt, chunk_size=24,
                               subsample=3, den=jden),
            tpc.make_chain_egs(feats, runs, ttr, tt, chunk_size=24,
                               subsample=3, den=tden))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _same_state(jt, tt, tol=1e-4):
    back = ttdnn.params_to_flax(tt.model.state_dict())
    for tree, jtree_ in (("params", jt.params),
                         ("batch_stats", dict(jt.batch_stats))):
        want = dict(jax.tree_util.tree_leaves_with_path(jtree_))
        got = dict(jax.tree_util.tree_leaves_with_path(back[tree]))
        assert set(got) == set(want)
        for k in want:
            assert _rel(got[k], want[k]) < tol, (tree, k)


@pytest.fixture(scope="module", params=["adamw", "ngsgd"])
def three_steps(request):
    """Three steps of each trainer on the same batches: the losses,
    diagnostics and both states after steps 1 and 3."""
    jt, tt = _trainers(request.param)
    jeg, teg = _egs()
    out = []
    for i in range(3):
        idx = np.arange(4 * i, 4 * i + 4) % jeg.feats.shape[0]
        ng = tuple(jnp.asarray(getattr(jeg, f)[idx]) for f in EGS_FIELDS[3:])
        (jt.params, jt.batch_stats, jt.opt_state, jl, jd) = jt._step(
            jt.params, jt.batch_stats, jt.opt_state,
            jnp.asarray(jeg.feats[idx]), jnp.asarray(jeg.pdf_ali[idx]),
            jnp.asarray(jeg.mask[idx]), ng)
        tl, td = tt._step(*tt.batches(teg, idx))
        state = None
        if i in (0, 2):
            state = (jax.tree_util.tree_map(np.asarray, jt.params),
                     jax.tree_util.tree_map(np.asarray, dict(jt.batch_stats)),
                     ttdnn.params_to_flax(tt.model.state_dict()))
        out.append((float(jl), {k: float(v) for k, v in jd.items()},
                    float(tl), {k: float(v) for k, v in td.items()}, state))
    return out


@pytest.mark.parametrize("n", [1, 3])
def test_steps_match_jax(three_steps, n):
    """After 1 and 3 steps: loss, objf/num/den, every parameter and
    batch statistic."""
    jl, jd, tl, td, state = three_steps[n - 1]
    assert tl == pytest.approx(jl, rel=1e-4)
    for k in ("objf", "num", "den"):
        assert td[k] == pytest.approx(jd[k], rel=1e-4, abs=1e-5), k
    jp, jbs, back = state
    for tree, want in (("params", jp), ("batch_stats", jbs)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            got = back[tree]
            for p in path:
                got = got[p.key]
            assert _rel(got, leaf) < 1e-4, (tree, path)


def test_max_change_clamps_update_norms():
    """Every tensor's applied update has l2 norm ≤ max_change under huge
    gradients, and the lr schedule decays to final_learning_rate
    (tests/test_chain.py::test_max_change_clamps_update_norms)."""
    _, (_, ttr, tden) = _sides()
    cfg = ttdnn.TdnnConfig(feat_dim=4, num_pdfs=ttr.num_pdfs, hidden_dim=8,
                           bottleneck_dim=4, num_layers=2,
                           frame_subsampling_factor=3)
    mc = 0.05
    tr = tpc.ChainTrainer(cfg, tden, tpc.ChainTrainConfig(
        num_epochs=1, batch_size=2, learning_rate=100.0, max_change=mc,
        total_steps=10, use_flexible_numerator=False), device="cpu")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    rng = np.random.default_rng(0)
    feats = 1e3 * rng.standard_normal((2, 12, 4)).astype(np.float32)
    tr._step(feats, np.zeros((2, 4), np.int32), np.ones((2, 4), np.float32))
    for k, p in tr.model.named_parameters():
        assert float(torch.linalg.norm(p.detach() - before[k])) <= mc + 1e-5
    sched = tpc.exponential_decay(1e-3, 10, 1e-4 / 1e-3)
    assert math.isclose(sched(10), 1e-4, rel_tol=1e-5)
    assert math.isclose(tr.opt.schedule(0), 100.0)


def test_chain_trainer_ngsgd_step():
    """optimizer="ngsgd" takes finite steps that move the parameters
    within max-change (tests/test_chain.py::test_chain_trainer_ngsgd_step)."""
    _, (_, ttr, tden) = _sides()
    cfg = ttdnn.TdnnConfig(feat_dim=4, num_pdfs=ttr.num_pdfs, hidden_dim=8,
                           bottleneck_dim=4, num_layers=2,
                           frame_subsampling_factor=3)
    mc = 0.5
    tr = tpc.ChainTrainer(cfg, tden, tpc.ChainTrainConfig(
        num_epochs=1, batch_size=2, learning_rate=1e-2, max_change=mc,
        total_steps=10, use_flexible_numerator=False, optimizer="ngsgd"),
        device="cpu")
    before = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 12, 4)).astype(np.float32)
    for _ in range(3):
        loss, _ = tr._step(feats, np.zeros((2, 4), np.int32),
                           np.ones((2, 4), np.float32))
    assert math.isfinite(float(loss))
    moved = 0.0
    for k, p in tr.model.named_parameters():
        d = float(torch.linalg.norm(p.detach() - before[k]))
        assert torch.isfinite(p).all() and d <= 3 * mc + 1e-5
        moved += d
    assert moved > 0.0


def test_train_two_epochs_matches_jax():
    """train(): the lr-decay horizon from the eg count, the batch order
    of default_rng(0), 2 epochs; the same final loss, objf and
    parameters."""
    jt, tt = _trainers("adamw", num_epochs=2, total_steps=None)
    jeg, teg = _egs()
    jout = jt.train(jeg, log_every=1000)
    tout = tt.train(teg, log_every=1000)
    assert tout["loss"] == pytest.approx(jout["loss"], rel=1e-4)
    assert tout["objf"] == pytest.approx(jout["objf"], rel=1e-4)
    _same_state(jt, tt)


def test_save_restore_round_trip(tmp_path):
    """A checkpoint restores the model, the optimizer state and the
    step: the next step from the restored trainer equals the next step
    of the one that saved."""
    _, tt = _trainers("ngsgd")
    _, teg = _egs()
    tt._step(*tt.batches(teg, np.arange(4)))
    tt._step(*tt.batches(teg, np.arange(4, 8)))
    tt.save(str(tmp_path), 2)
    _, other = _trainers("ngsgd")
    assert other.restore(str(tmp_path)) == 2
    assert other.opt.count == 2
    for a, b in ((tt, other),):
        la, _ = a._step(*a.batches(teg, np.arange(8, 12)))
        lb, _ = b._step(*b.batches(teg, np.arange(8, 12)))
        assert float(la) == float(lb)
        for (k, p), q in zip(a.model.state_dict().items(),
                             b.model.state_dict().values()):
            assert torch.equal(p, q), k
    with pytest.raises(KaldiError, match="no checkpoint"):
        other.restore(str(tmp_path / "none"))


def test_adamw_matches_optax_adamw():
    """AdamW alone against optax.adamw under an exponential decay, with
    the max-change clamp optax's chain applies after it: 4 steps on
    matrices and a bias, one of them clamped (atol 1e-6)."""
    import optax
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": (6,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    sched = optax.exponential_decay(3e-2, transition_steps=4,
                                    decay_rate=0.1)
    tx = optax.adamw(sched)
    jp = {n: jnp.asarray(p.copy()) for n, p in params.items()}
    st = tx.init(jp)
    tp = {n: torch.nn.Parameter(torch.tensor(p)) for n, p in params.items()}
    opt = tpc.AdamW(list(tp.values()), tpc.exponential_decay(3e-2, 4, 0.1),
                    max_change=0.1)
    for _ in range(4):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        u, st = tx.update({n: jnp.asarray(v) for n, v in g.items()}, st, jp)
        u = {n: v * min(1.0, 0.1 / float(jnp.sqrt(jnp.sum(v * v) + 1e-20)))
             for n, v in u.items()}
        jp = optax.apply_updates(jp, u)
        for n, p in tp.items():
            p.grad = torch.tensor(g[n])
        opt.step()
        for n in shapes:
            np.testing.assert_allclose(tp[n].detach().numpy(),
                                       np.asarray(jp[n]), atol=1e-6)
    assert opt.count == 4


def test_scores_fn_is_the_eval_forward():
    """scores_fn: the model in eval mode on the running statistics, as
    the original's jitted scorer (rtol/atol 1e-4)."""
    jt, tt = _trainers("adamw")
    x = np.random.default_rng(6).standard_normal((2, 15, 5)).astype(
        np.float32)
    want = np.asarray(jt.scores_fn()(jnp.asarray(x)))
    got = tt.scores_fn()(x)
    assert not got.requires_grad and not tt.model.training
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
