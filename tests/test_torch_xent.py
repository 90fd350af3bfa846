"""The port's cross-entropy trainer (kaldi_tpu_torch/pipelines/nnet.py)
against the JAX package's (kaldi_tpu/pipelines/nnet.py): egs and
priors, one Adam step, loglikes_fn, and a short training run.

Both trainers hold the same numpy-drawn TDNN-F weights (through
``params_from_flax``; the output layer nonzero).  Tolerances: egs and
priors exact; loss and frame accuracy 1e-5 relative; one Adam step as
tests/test_torch_rnnlm.py bounds it (1e-3·lr plus the step's
sensitivity lr·eps·δg/(|g| + eps)² to a gradient error δg of 1e-5 of
the tensor's largest gradient); batch statistics and pseudo-loglikes
1e-5 of their largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am.tdnn import TdnnConfig as JCfg
from kaldi_tpu.pipelines import nnet as jn
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.pipelines import nnet as tn

torch.set_num_threads(1)

CFG = dict(feat_dim=6, num_pdfs=9, hidden_dim=16, bottleneck_dim=4,
           num_layers=2, frame_subsampling_factor=1)
LR = 1e-2
ADAM_EPS = 1e-8


def _data(seed=0, n=5):
    rng = np.random.default_rng(seed)
    feats, ali = {}, {}
    for i in range(n):
        T = int(rng.integers(40, 90))
        a = rng.integers(0, CFG["num_pdfs"], T).astype(np.int32)
        feats[f"u{i}"] = (rng.standard_normal((T, 6)) + 0.5 * a[:, None]) \
            .astype(np.float32)
        ali[f"u{i}"] = a
    return feats, ali


def _trainers(**kw):
    """The JAX trainer with numpy-drawn weights and the port's trainer
    holding the same ones."""
    xcfg = dict(num_epochs=1, batch_size=4, chunk_size=16, learning_rate=LR)
    xcfg.update(kw)
    jt = jn.XentTrainer(JCfg(**CFG), jn.XentTrainConfig(**xcfg))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, jt.params))
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    tt = tn.XentTrainer(ttdnn.TdnnConfig(**CFG), tn.XentTrainConfig(**xcfg),
                        device="cpu")
    tt.model.load_state_dict(ttdnn.params_from_flax(
        {"params": params, "batch_stats": jax.tree_util.tree_map(
            np.asarray, dict(jt.batch_stats))}))
    return jt, tt


def test_make_egs_and_priors_equal_jax():
    jt, tt = _trainers()
    feats, ali = _data()
    for a, b in zip(jt.make_egs(feats, ali), tt.make_egs(feats, ali)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jt.log_priors, tt.log_priors)


def test_one_step_matches_optax():
    """Loss, frame accuracy, every weight (the first Adam step's bar)
    and the batch statistics after one step on the same batch."""
    jt, tt = _trainers()
    X, Y, M = tt.make_egs(*_data())
    idx = np.arange(4)
    init = {k: v.clone() for k, v in tt.model.state_dict().items()}
    grads = {}
    real_step = torch.optim.Adam.step

    def spy(self, *a, **k):
        for n, p in tt.model.named_parameters():
            grads[n] = p.grad.detach().clone()
        return real_step(self, *a, **k)

    tt.opt.step = spy.__get__(tt.opt)
    tl, ta = tt._step(X[idx], Y[idx], M[idx])
    (jt.params, jt.batch_stats, jt.opt_state, jl, ja) = jt._step(
        jt.params, jt.batch_stats, jt.opt_state, jnp.asarray(X[idx]),
        jnp.asarray(Y[idx]), jnp.asarray(M[idx]))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(ta) == pytest.approx(float(ja), rel=1e-5)
    want = ttdnn.params_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.params,
                     "batch_stats": dict(jt.batch_stats)}))
    got = tt.model.state_dict()
    moved = 0
    for k, g in grads.items():
        g = g.double().abs()
        tol = 1e-3 * LR + LR * ADAM_EPS * (1e-5 * float(g.max())) / \
            (g + ADAM_EPS) ** 2
        assert bool(((got[k].double() - want[k].double()).abs()
                     <= tol).all()), k
        moved += int((got[k] != init[k]).sum())
    assert moved > 0
    for k in got:
        if k.endswith((".mean", ".var")):
            w = want[k]
            assert float((got[k] - w).abs().max()) <= \
                1e-5 * float(w.abs().max()), k


def test_loglikes_fn_matches_jax():
    """log-softmax − log-priors in eval mode, after make_egs set the
    priors."""
    jt, tt = _trainers()
    feats, ali = _data()
    jt.make_egs(feats, ali)
    tt.make_egs(feats, ali)
    x = feats["u0"]
    want = np.asarray(jt.loglikes_fn()(jnp.asarray(x)))
    got = tt.loglikes_fn()(x).numpy()
    assert got.shape == (x.shape[0], CFG["num_pdfs"])
    np.testing.assert_allclose(got, want,
                               atol=1e-5 * float(np.abs(want).max()))


def test_training_raises_frame_accuracy():
    """train() over 8 epochs lowers the loss and raises the frame
    accuracy of the eval-mode model over the egs."""
    _, tt = _trainers(num_epochs=8)
    feats, ali = _data()

    def acc():
        tt.make_egs(feats, ali)
        hits = n = 0
        f = tt.loglikes_fn()
        for u in feats:
            hits += int((f(feats[u]).argmax(-1).numpy() == ali[u]).sum())
            n += len(ali[u])
        return hits / n

    before = acc()
    out = tt.train(feats, ali)
    assert np.isfinite(out["loss"]) and acc() > before + 0.1
