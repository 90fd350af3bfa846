"""The port's NG-SGD (kaldi_tpu_torch/ops/natural_gradient.py) against
the JAX package's ops/natural_gradient.py, and the six tests of
tests/test_natural_gradient.py mirrored on the port.

States are compared by what every use of them reads: the projector
U Uᵀ, d and ρ (QR and eigh pick eigenvector signs freely).  Tolerances:
one advance rtol 1e-4 / atol 1e-5 (float32 QR and eigh in two
libraries); preconditioned updates and 5 optimizer steps atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kaldi_tpu.ops import natural_gradient as jng
from kaldi_tpu_torch.ops import natural_gradient as tng

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_skewed_samples(rng, N, D, top_eigs):
    """Gaussian with a few large eigendirections over a small floor."""
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    scales = np.full(D, 0.1)
    scales[:len(top_eigs)] = top_eigs
    return (rng.standard_normal((N, D)) * np.sqrt(scales)) @ Q.T, Q, scales


def _t(a):
    """A float32 copy: jnp.asarray may share a numpy array's memory, so
    nothing here aliases what the JAX side holds."""
    return torch.tensor(np.asarray(a, np.float32))


def _same_state(tst, jst, rtol=1e-4, atol=1e-5):
    U, jU = tst.U.numpy(), np.asarray(jst.U)
    np.testing.assert_allclose(U @ U.T, jU @ jU.T, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tst.d.numpy(), np.asarray(jst.d), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(float(tst.rho), float(jst.rho), rtol=rtol,
                               atol=atol)
    assert tst.t == int(jst.t)


def _advanced_pair(rng, D=12, R=4, steps=3, N=40):
    """The same estimator advanced ``steps`` times on each side."""
    js, ts = jng.ng_init(D, R), tng.ng_init(D, R)
    for _ in range(steps):
        X = make_skewed_samples(rng, N, D, [30.0, 10.0, 5.0])[0]
        js = jng.ng_advance(js, jnp.asarray(X, jnp.float32))
        ts = tng.ng_advance(ts, _t(X))
    return ts, js


@pytest.mark.parametrize("steps", [1, 4])
def test_ng_advance_matches_jax(rng, steps):
    """The first advance (η = 1) and later ones (EMA)."""
    ts, js = _advanced_pair(rng, steps=steps)
    _same_state(ts, js)


def test_ng_apply_and_precondition_match_jax(rng):
    ts, js = _advanced_pair(rng)
    X = rng.standard_normal((20, 12)).astype(np.float32)
    np.testing.assert_allclose(tng.ng_apply(ts, _t(X)).numpy(),
                               np.asarray(jng.ng_apply(js, jnp.asarray(X))),
                               rtol=1e-4, atol=1e-5)
    tb, tg, ts2 = tng.ng_precondition(ts, _t(X))
    jb, jg, js2 = jng.ng_precondition(js, jnp.asarray(X))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-4)
    _same_state(ts2, js2)


def test_batched_advance_equals_one_at_a_time(rng):
    """One batched QR / eigh over several sides gives each side's own
    advance."""
    states = [tng.ng_init(D, 4) for D in (12, 12, 9)]
    Xs = [_t(rng.standard_normal((30, s.U.shape[0]))) for s in states]
    many = tng._advance_many(states, Xs)
    for s, X, m in zip(states, Xs, many):
        one = tng.ng_advance(s, X)
        np.testing.assert_allclose((m.U @ m.U.T).numpy(),
                                   (one.U @ one.U.T).numpy(), atol=1e-6)
        np.testing.assert_allclose(m.d.numpy(), one.d.numpy(), rtol=1e-6)


def _train_pair(lr, steps, momentum, update_period, rng, shapes):
    """``steps`` NgSgd updates on the port and ngsgd updates in optax on
    the same gradients; → (port params, jax params) per step."""
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    # torch layout (out, in) is flax's kernel transposed
    jparams = {n: jnp.asarray(p.T if p.ndim == 2 else p)
               for n, p in params.items()}
    tparams = {n: torch.nn.Parameter(_t(p)) for n, p in params.items()}
    tx = jng.ngsgd(lr, momentum=momentum, update_period=update_period)
    jst = tx.init(jparams)
    opt = tng.NgSgd(list(tparams.values()), lr, momentum=momentum,
                    update_period=update_period)
    out = []
    for _ in range(steps):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in params.items()}
        for n, p in tparams.items():
            p.grad = _t(grads[n])
        opt.step()
        u, jst = tx.update({n: jnp.asarray(g.T if g.ndim == 2 else g)
                            for n, g in grads.items()}, jst, jparams)
        jparams = optax.apply_updates(jparams, u)
        out.append(({n: p.detach().numpy().copy()
                     for n, p in tparams.items()},
                    {n: np.asarray(p.T if p.ndim == 2 else p)
                     for n, p in jparams.items()}))
    return out, opt, jst


def test_ngsgd_five_steps_match_jax(rng):
    """5 NgSgd steps with momentum equal ngsgd's on the same gradients
    (atol 1e-5), across the first call's pass-through and the
    preconditioned steps, on matrices of two shapes and a bias.  Both
    sides of each matrix see at least rank + 1 samples: with fewer, the
    tracked subspace is not unique and two eigensolvers may pick
    different ones."""
    steps, _, _ = _train_pair(1e-2, 5, 0.9, 4, rng,
                              {"w": (24, 32), "v": (30, 26), "b": (24,)})
    for tp, jp in steps:
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], atol=1e-5, err_msg=n)


def test_update_period_schedule_matches_jax(rng):
    """Estimates advance on every one of the first 10 steps, then every
    update_period-th; the counts agree with the optax state's."""
    _, opt, jst = _train_pair(1e-3, 14, None, 3, rng, {"w": (5, 4)})
    p = opt.param_groups[0]["params"][0]
    jt = int(jst[0].states["w"][0].t)
    assert opt.state[p]["ng_in"]["t"] == opt.state[p]["ng_out"]["t"] == jt
    assert jt == 11                     # steps 0-9, then step 12
    assert opt.count == 14


# -- tests/test_natural_gradient.py, mirrored on the port -------------------

def test_estimate_tracks_top_eigenspace(rng):
    D, R = 16, 4
    X_all, Q, scales = make_skewed_samples(rng, 4000, D, [50.0, 30.0, 20.0,
                                                          10.0])
    st = tng.ng_init(D, R)
    for i in range(0, 4000, 200):
        _, _, st = tng.ng_precondition(st, _t(X_all[i:i + 200]))
    U = st.U.numpy()
    overlap = np.linalg.norm(Q[:, :R].T @ U, ord="fro") ** 2 / R
    assert overlap > 0.9, overlap
    d = st.d.numpy()
    assert np.all(np.diff(d) <= 1e-4)
    assert d[0] == pytest.approx(50.0, rel=0.5)
    tot = d.sum() + float(st.rho) * (D - R)
    assert tot == pytest.approx(scales.sum(), rel=0.3)


def test_preconditioning_whitens_and_preserves_scale(rng):
    D, R = 12, 4
    X_all, _, _ = make_skewed_samples(rng, 3000, D, [100.0, 40.0])
    st = tng.ng_init(D, R)
    for i in range(0, 2000, 250):
        _, _, st = tng.ng_precondition(st, _t(X_all[i:i + 250]))
    X = _t(X_all[2000:2250])
    Xbar, gamma, _ = tng.ng_precondition(st, X)
    assert float(gamma) * float(torch.linalg.norm(Xbar)) == pytest.approx(
        float(torch.linalg.norm(X)), rel=1e-4)

    def anis(M):
        v = np.linalg.eigvalsh(M.numpy().T @ M.numpy())
        return v[-1] / np.maximum(v[v > 1e-6].min(), 1e-6)
    assert anis(Xbar) < anis(X) / 5.0


def test_first_call_passthrough():
    st = tng.ng_init(6, 3)
    X = torch.ones((4, 6))
    Xbar, gamma, st2 = tng.ng_precondition(st, X)
    np.testing.assert_allclose(Xbar.numpy(), X.numpy())
    assert float(gamma) == 1.0
    assert st2.t == 1


def test_ngsgd_beats_sgd_on_ill_conditioned_quadratic(rng):
    D = 10
    scales = np.logspace(0, 3, D)
    A = _t(rng.standard_normal((200, D)) * np.sqrt(scales))
    Y = A @ _t(rng.standard_normal((D, 3)))

    def loss(W):
        r = A @ W.T - Y
        return 0.5 * torch.mean(torch.sum(r * r, dim=1))

    def train(make_opt, steps=150):
        W = torch.nn.Parameter(torch.zeros((3, D)))
        opt = make_opt([W])
        for _ in range(steps):
            opt.zero_grad()
            loss(W).backward()
            opt.step()
        return float(loss(W).detach())

    lr = 1e-4
    l_sgd = train(lambda p: torch.optim.SGD(p, lr))
    l_ng = train(lambda p: tng.NgSgd(p, lr, rank_in=2, rank_out=8,
                                     alpha=0.5))
    assert l_ng < l_sgd * 0.5, (l_ng, l_sgd)


def test_ngsgd_passes_non_matrices_and_the_first_call(rng):
    w = torch.nn.Parameter(torch.ones((3, 4)))
    b = torch.nn.Parameter(torch.ones(3))
    opt = tng.NgSgd([w, b], 1.0)
    gw = _t(rng.standard_normal((3, 4)))
    gb = _t(rng.standard_normal(3))
    w.grad, b.grad = gw.clone(), gb.clone()
    opt.step()
    np.testing.assert_allclose((1 - b).detach().numpy(), gb.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose((1 - w).detach().numpy(), gw.numpy(),
                               rtol=1e-5)
    before = w.detach().clone()
    w.grad, b.grad = gw.clone(), gb.clone()
    opt.step()
    assert not np.allclose((before - w).detach().numpy(), gw.numpy())


def test_ngsgd_update_period(rng):
    w = torch.nn.Parameter(torch.ones((4, 6)))
    opt = tng.NgSgd([w], 1.0, update_period=3)
    g = _t(rng.standard_normal((4, 6)))

    def step():
        before = w.detach().clone()
        w.grad = g.clone()
        opt.step()
        return (before - w).detach().numpy()

    for _ in range(10):
        step()
    assert opt.state[w]["ng_in"]["t"] == 10
    u10 = step()                # step 10: no advance (10 % 3 == 1)
    u11 = step()                # step 11: no advance
    assert opt.state[w]["ng_in"]["t"] == 10
    step()                      # step 12: advances
    assert opt.state[w]["ng_in"]["t"] == 11
    assert not np.allclose(u10, g.numpy())
    np.testing.assert_allclose(u10, u11, rtol=1e-6)
