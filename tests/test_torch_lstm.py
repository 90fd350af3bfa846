"""The port's LSTM acoustic model (kaldi_tpu_torch/am/lstm.py) against
flax's (kaldi_tpu/am/lstm.py), mirroring tests/test_lstm.py: shapes,
gradients, exact carried-state streaming, and the restricted-attention
band (am/tdnn.py).

flax's variables cross through ``state_dict_from_flax``; the output
kernel, which flax starts at zero, is drawn from numpy.  Tolerances:
forward outputs and carries 1e-5 of their largest entry; gradients 1e-4
of each tensor's largest entry; streamed = offline within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import lstm as jl
from kaldi_tpu.am.tdnn import RestrictedAttentionLayer as JAtt
from kaldi_tpu_torch.am import lstm as tl
from kaldi_tpu_torch.am import tdnn as ttdnn

torch.set_num_threads(1)

CFG = dict(feat_dim=8, num_pdfs=12, hidden_dim=16, proj_dim=8,
           num_layers=2, frame_subsampling_factor=3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


@pytest.fixture(scope="module")
def models():
    """(flax model, its variables, the port's model holding them)."""
    jm = jl.LstmChain(jl.LstmConfig(**CFG))
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 30, 8))))
    v["params"]["output_affine"]["kernel"] = np.random.default_rng(5) \
        .standard_normal((8, 12)).astype(np.float32)
    tm = tl.LstmChain(tl.LstmConfig(**CFG))
    tm.load_state_dict(ttdnn.state_dict_from_flax(v))
    return jm, v, tm


def test_lstm_shapes(models):
    """(2, 10, 12) scores and one (c, h) carry of (2, 16) a layer, equal
    to flax's; the state dict holds flax's eight cell leaves a layer
    apart (not one packed weight)."""
    jm, v, tm = models
    x = np.ones((2, 30, 8), np.float32)
    jo, jc = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out, carries = tm(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 10, 12) and len(carries) == 2
    assert tuple(carries[0][0].shape) == (2, 16)
    assert _rel(out, jo) < 1e-5
    for (c, h), (jcc, jh) in zip(carries, jc):
        assert _rel(c, jcc) < 1e-5 and _rel(h, jh) < 1e-5
    cell = sorted(k for k in tm.state_dict() if k.startswith("lstm1.cell"))
    assert [k.split(".")[2] for k in cell if k.endswith("weight")] == \
        ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]


def test_lstm_streaming_exact(models, rng):
    """Carried-state chunked scoring equals the offline forward (the
    looped-computation contract), and equals flax's streamed scores;
    reset starts a fresh stream."""
    jm, v, tm = models
    T = 60
    feats = rng.standard_normal((T, 8)).astype(np.float32)
    with torch.no_grad():
        offline = tm(torch.from_numpy(feats[None]))[0][0].numpy()
    sc = tl.StreamingLstmScorer(tm)
    jsc = jl.StreamingLstmScorer(v["params"], jm)
    outs, jouts = [], []
    for i in range(0, T, 12):        # 12 % 3 == 0
        outs.append(sc.accept_features(feats[i:i + 12]))
        jouts.append(jsc.accept_features(feats[i:i + 12]))
    streamed = np.concatenate(outs)
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, rtol=1e-5, atol=1e-5)
    assert _rel(streamed, np.concatenate(jouts)) < 1e-5
    sc.reset()
    np.testing.assert_allclose(sc.accept_features(feats[:12]), offline[:4],
                               rtol=1e-5, atol=1e-5)


def test_lstm_gradients_flow(models, rng):
    """The NLL's gradient reaches every leaf, finite, and equals flax's."""
    jm, v, tm = models
    x = rng.standard_normal((2, 30, 8)).astype(np.float32)
    tgt = rng.integers(0, 12, (2, 10))

    def loss(p):
        out, _ = jm.apply({"params": p}, jnp.asarray(x))
        lp = jax.nn.log_softmax(out)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(tgt)[..., None],
                                             2))

    jg = ttdnn.state_dict_from_flax({"params": jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(v["params"]))})
    tm.zero_grad()
    out, _ = tm(torch.from_numpy(x))
    lp = torch.log_softmax(out, -1)
    (-torch.gather(lp, 2, torch.from_numpy(tgt)[..., None]).mean()) \
        .backward()
    for k, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        assert _rel(p.grad, jg[k]) < 1e-4, k
    assert max(float(p.grad.abs().max()) for p in tm.parameters()) > 0


def test_restricted_attention_band(rng):
    """Attention outside the context band has no influence; inside it
    does; the layer's output equals flax's (both in eval mode, as
    flax's ``apply`` runs it by default)."""
    x = rng.standard_normal((1, 20, 8)).astype(np.float32)
    jlayer = JAtt(dim=8, num_heads=2, left_ctx=2, right_ctx=2)
    v = jax.tree_util.tree_map(np.asarray, jlayer.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    layer = ttdnn.RestrictedAttentionLayer(8, 8, num_heads=2, left_ctx=2,
                                           right_ctx=2)
    layer.load_state_dict(ttdnn.state_dict_from_flax(v))

    def run(a):
        with torch.no_grad():
            return layer.eval()(torch.from_numpy(a))[0].numpy()

    y0 = run(x)
    jy = jlayer.apply(v, jnp.asarray(x), mutable=["batch_stats"])[0]
    assert _rel(y0, np.asarray(jy)[0]) < 1e-5
    x2 = x.copy()
    x2[0, 16] += 100.0
    np.testing.assert_allclose(y0[10], run(x2)[10], atol=1e-4)
    x3 = x.copy()
    x3[0, 11] += 100.0
    assert np.abs(run(x3)[10] - y0[10]).max() > 1e-3


def test_lstm_recurrence_runs_cudnn_without_tf32(models, monkeypatch, rng):
    """With a card present, the packed recurrence runs forward and
    backward under cuDNN flags with allow_tf32 off, whatever the global
    flag; outputs and every leaf's gradient equal the plain call's."""
    _, _, tm = models
    x = torch.from_numpy(rng.standard_normal((2, 9, 8)).astype(np.float32))

    def run():
        tm.zero_grad()
        out, _ = tm(x)
        (out ** 2).sum().backward()
        return out.detach(), {k: p.grad.clone()
                              for k, p in tm.named_parameters()}

    want, wgrads = run()
    seen = []
    cell = tm.lstm1.cell
    real = type(cell)._recur

    def spy(self, *a):
        seen.append(torch.backends.cudnn.allow_tf32)
        out = real(self, *a)
        out[0].register_hook(lambda g: seen.append(
            torch.backends.cudnn.allow_tf32))
        return out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(type(cell), "_recur", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    got, grads = run()
    assert seen == [False] * 4 and torch.backends.cudnn.allow_tf32
    torch.testing.assert_close(got, want)
    for k in wgrads:
        torch.testing.assert_close(grads[k], wgrads[k])
