"""The port's nnet1 library (am/nnet1.py) against kaldi_tpu/am/nnet1.py on
the CPU.

The same seeded numpy inputs go through both sides: ``cd1_update`` step
by step, ``train_rbm`` and ``pretrain_dbn``, ``SigmoidDnn``'s forward
from the JAX package's own initialisation (flax's ``init``, carried
through ``nnet1_model``), ``finetune_xent`` from the same start with and
without per-layer learning-rate factors, ``dnn_params_from_dbn``, and the
``<Nnet1>`` file both ways.

CD-1 samples its hidden states by comparing uniform draws with the
hidden probabilities.  The JAX side draws them from ``jax.random``; the
port's ``cd1_update`` takes them as an argument, and its ``train_rbm``
draws them through ``draw_uniform``, which these tests replace with a
replay of JAX's draws (``PRNGKey(seed)``, then ``key, sub = split(key)``
and ``uniform(sub, (B, hid))`` a step).  A sample flips between the two
sides only where a draw lies within float32 rounding (~1e-7) of its
probability: over every draw of these tests (about 8,000) that is
expected about 2e-3 times, and the tests count the draws that close to
their probability and require none, so that the bars below hold
without a flip.  Bars: one step's parameters and error within 1e-6 of
each tensor's largest entry, a trained RBM's within 1e-5, forwards
within 1e-5, fine-tuned parameters within 1e-4 (float32 sums in another
order); a frozen layer and the ``<Nnet1>`` files bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import nnet1 as jn
from kaldi_tpu_torch.am import nnet1 as tn
from kaldi_tpu_torch.core.logging import KaldiError

torch.set_num_threads(1)

HID = (7, 5)
IN_DIM = 6
P = 4
NEAR = 1e-6          # a draw this close to its probability could flip


def close(got, want, tol):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def trees_close(got, want, tol):
    lg, lw = list(tree_leaves(got)), list(tree_leaves(want))
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (p, g), (_, w) in zip(lg, lw):
        close(g, w, tol)


def frames(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


class Replay:
    """``draw_uniform`` replaced by JAX's draws: a key per generator
    (``PRNGKey`` of its seed), split once a call, as the original's
    ``train_rbm`` splits its key once a step.  Counts the draws that lie
    within NEAR of the hidden probabilities they are compared with."""

    def __init__(self):
        self.keys = {}
        self.draws = 0

    def __call__(self, gen, shape, device):
        k = self.keys.get(id(gen))
        if k is None:
            k = jax.random.PRNGKey(gen.initial_seed())
        k, sub = jax.random.split(k)
        self.keys[id(gen)] = k
        self.draws += int(np.prod(shape))
        return torch.tensor(np.asarray(
            jax.random.uniform(sub, tuple(shape)))).to(device)


@pytest.fixture
def replay(monkeypatch):
    r = Replay()
    near = []
    real = tn.cd1_update

    def counted(rbm, v0, u, lr, gaussian_visible):
        p = torch.sigmoid(v0 @ rbm["W"] + rbm["hid_bias"])
        near.append(int((torch.abs(u - p) < NEAR).sum()))
        return real(rbm, v0, u, lr, gaussian_visible)

    monkeypatch.setattr(tn, "draw_uniform", r)
    monkeypatch.setattr(tn, "cd1_update", counted)
    r.near = near
    return r


def rbm_state(vis, hid, seed):
    rng = np.random.default_rng(seed)
    return {"W": (rng.standard_normal((vis, hid)) * 0.3).astype(np.float32),
            "vis_bias": (rng.standard_normal(vis) * 0.1).astype(np.float32),
            "hid_bias": (rng.standard_normal(hid) * 0.1).astype(np.float32)}


# ---------------------------------------------------------------------------
# CD-1 and the RBM stack

@pytest.mark.parametrize("gaussian", [True, False])
def test_cd1_update_step_by_step(gaussian):
    """Five chained steps, each side from its own state, the port given
    the uniforms JAX draws inside its step."""
    jr = {k: jnp.asarray(v) for k, v in rbm_state(6, 5, 1).items()}
    tr = {k: torch.tensor(v) for k, v in rbm_state(6, 5, 1).items()}
    key = jax.random.PRNGKey(3)
    near = 0
    for step in range(5):
        v0 = frames(16, 6, 10 + step)
        if not gaussian:
            v0 = 1.0 / (1.0 + np.exp(-v0))
        key, sub = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sub, (16, 5)))
        p = torch.sigmoid(torch.from_numpy(v0) @ tr["W"] + tr["hid_bias"])
        near += int((torch.abs(torch.tensor(u) - p) < NEAR).sum())
        jr, jerr = jn.cd1_update(jr, jnp.asarray(v0), sub, 0.05, gaussian)
        tr, terr = tn.cd1_update(tr, torch.from_numpy(v0),
                                 torch.tensor(u), 0.05, gaussian)
        for k in jr:
            close(tr[k], jr[k], 1e-6)
        assert float(terr) == pytest.approx(float(jerr), rel=1e-6)
    assert near == 0


@pytest.mark.parametrize("gaussian", [True, False])
def test_train_rbm_with_replayed_draws(replay, gaussian):
    data = frames(80, IN_DIM, 4)
    if not gaussian:
        data = 1.0 / (1.0 + np.exp(-data))
    jrbm, jerrs = jn.train_rbm(data, 5, num_epochs=2, batch_size=16,
                               lr=0.05, gaussian_visible=gaussian, seed=9)
    trbm, terrs = tn.train_rbm(data, 5, num_epochs=2, batch_size=16,
                               lr=0.05, gaussian_visible=gaussian, seed=9,
                               device="cpu")
    assert sum(replay.near) == 0 and replay.draws == 2 * 5 * 16 * 5
    for name in ("W", "vis_bias", "hid_bias"):
        close(getattr(trbm, name), getattr(jrbm, name), 1e-5)
        assert getattr(trbm, name).dtype == np.float32
    assert trbm.gaussian_visible == gaussian
    np.testing.assert_allclose(terrs, jerrs, rtol=1e-5)


def test_pretrain_dbn_with_replayed_draws(replay):
    data = frames(300, IN_DIM, 5)      # 1 minibatch of 256 an epoch
    jrbms = jn.pretrain_dbn(data, HID, num_epochs=2, seed=2)
    trbms = tn.pretrain_dbn(data, HID, num_epochs=2, seed=2, device="cpu")
    assert sum(replay.near) == 0 and replay.draws == 2 * 256 * sum(HID)
    assert [r.gaussian_visible for r in trbms] == [True, False]
    for t, j in zip(trbms, jrbms):
        for name in ("W", "vis_bias", "hid_bias"):
            close(getattr(t, name), getattr(j, name), 1e-5)


def test_train_rbm_draws_from_a_seeded_generator():
    """Without the replay the draws come from ``torch.Generator(seed)``:
    the same seed gives the same RBM, bit for bit."""
    data = frames(48, IN_DIM, 6)
    a, ea = tn.train_rbm(data, 5, num_epochs=2, batch_size=16, seed=4,
                         device="cpu")
    b, eb = tn.train_rbm(data, 5, num_epochs=2, batch_size=16, seed=4,
                         device="cpu")
    np.testing.assert_array_equal(a.W, b.W)
    assert ea == eb and ea[-1] < ea[0] * 1.5


def test_dnn_params_from_dbn_equal():
    rng = np.random.default_rng(8)
    rbms = [jn.RbmParams(rng.standard_normal((IN_DIM, 7)).astype(np.float32),
                         np.zeros(IN_DIM, np.float32),
                         rng.standard_normal(7).astype(np.float32), True)]
    want = jax.tree_util.tree_map(np.asarray,
                                  jn.dnn_params_from_dbn(rbms, P, seed=3))
    got = tn.dnn_params_from_dbn([tn.RbmParams(r.W, r.vis_bias, r.hid_bias,
                                               True) for r in rbms], P, 3)
    trees_close(got, want, 0.0)


# ---------------------------------------------------------------------------
# the sigmoid DNN

@pytest.fixture(scope="module")
def jparams():
    params = jn.SigmoidDnn(HID, P).init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 4, IN_DIM)))["params"]
    return jax.tree_util.tree_map(np.asarray, dict(params))


def test_forward_from_carried_weights(jparams):
    x = frames(2 * 9, IN_DIM, 11).reshape(2, 9, IN_DIM)
    want = np.asarray(jn.SigmoidDnn(HID, P).apply({"params": jparams},
                                                  jnp.asarray(x)))
    model = tn.nnet1_model(jparams, HID, P, "cpu")
    with torch.no_grad():
        close(model(torch.from_numpy(x)), want, 1e-5)
    back = tn.nnet1_params(model)
    trees_close(back, jparams, 0.0)
    assert tn.layer_names(HID) == ("hidden1", "hidden2", "output_affine")


def test_model_needs_a_card_unless_asked(jparams):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(KaldiError, match="no CUDA card"):
        tn.nnet1_model(jparams, HID, P)


def test_init_nnet1_draws_flax_distributions():
    params = tn.init_nnet1(40, (256, 256), 30, torch.Generator()
                           .manual_seed(1))
    assert [p for p, _ in tree_leaves(params)] == [
        ("hidden1", "bias"), ("hidden1", "kernel"), ("hidden2", "bias"),
        ("hidden2", "kernel"), ("output_affine", "bias"),
        ("output_affine", "kernel")]
    for path, v in tree_leaves(params):
        if path[-1] == "bias":
            assert not v.any()
        else:
            assert 0.9 < float(np.std(v)) * np.sqrt(v.shape[0]) < 1.1
            # truncated at 2 standard normals before flax's rescaling
            assert np.abs(v).max() <= 2.0 / np.sqrt(v.shape[0]) / 0.8796



@pytest.mark.parametrize("factors", [None, {"hidden1": 0.0,
                                            "output_affine": 0.5}])
def test_finetune_xent(jparams, factors):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((70, IN_DIM)).astype(np.float32)
    y = rng.integers(0, P, 70).astype(np.int32)
    want, wloss = jn.finetune_xent(dict(jparams), HID, P, x, y,
                                   num_epochs=3, batch_size=16, lr=0.5,
                                   seed=5, lr_factors=factors)
    want = jax.tree_util.tree_map(np.asarray, dict(want))
    got, tloss = tn.finetune_xent(jparams, HID, P, x, y, num_epochs=3,
                                  batch_size=16, lr=0.5, seed=5,
                                  lr_factors=factors, device="cpu")
    trees_close(got, want, 1e-4)
    assert tloss == pytest.approx(wloss, rel=1e-4)
    if factors:
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(got["hidden1"][k],
                                          jparams["hidden1"][k])
    else:
        assert not np.array_equal(got["hidden1"]["kernel"],
                                  jparams["hidden1"]["kernel"])


# ---------------------------------------------------------------------------
# the <Nnet1> file

@pytest.mark.parametrize("extras", ["none", "priors", "both"])
def test_save_nnet1_byte_equal(tmp_path, jparams, extras):
    pri = np.linspace(1.0, 4.0, P).astype(np.float32) \
        if extras != "none" else None
    lrf = np.asarray([1.0, 0.5, 0.0], np.float32) if extras == "both" \
        else None
    jn.save_nnet1(str(tmp_path / "j.nnet"), jparams, HID, P, priors=pri,
                  lr_factors=lrf)
    tn.save_nnet1(str(tmp_path / "t.nnet"), jparams, HID, P, priors=pri,
                  lr_factors=lrf)
    tn.save_nnet1(str(tmp_path / "m.nnet"),
                  tn.nnet1_model(jparams, HID, P, "cpu"), HID, P,
                  priors=pri, lr_factors=lrf)
    raw = [(tmp_path / n).read_bytes() for n in ("j.nnet", "t.nnet",
                                                  "m.nnet")]
    assert raw[0] == raw[1] == raw[2]
    params, hid, npdf, priors, lr = tn.load_nnet1_full(str(tmp_path /
                                                           "j.nnet"))
    trees_close(params, jparams, 0.0)
    assert hid == HID and npdf == P
    if pri is None:
        assert priors is None
    else:
        np.testing.assert_array_equal(priors, pri)
    if lrf is None:
        assert lr is None
    else:
        np.testing.assert_array_equal(lr, lrf)
    jp, jh, jpdf, jpri = jn.load_nnet1(str(tmp_path / "t.nnet"))
    assert tuple(jh) == HID and jpdf == P
    trees_close(jp, jparams, 0.0)
    assert tn.load_nnet1(str(tmp_path / "j.nnet"))[1:3] == (HID, P)


def test_load_nnet1_rejects_a_stray_token(tmp_path, jparams):
    path = str(tmp_path / "bad.nnet")
    tn.save_nnet1(path, jparams, HID, P)
    raw = open(path, "rb").read().replace(b"</Nnet1>", b"<Nnet1X>")
    open(path, "wb").write(raw)
    with pytest.raises(KaldiError, match="unexpected token"):
        tn.load_nnet1_full(path)
