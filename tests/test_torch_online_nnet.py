"""PyTorch OnlineNnetScorer against kaldi_tpu's (CPU tensors).

Mirrors tests/test_online_nnet.py: TDNN scores streamed in chunks of 9,
30 and 75 feature frames equal the JAX scorer's within 1e-4 and the
offline forward's, and streamed scores through the dense streaming
decoder equal the JAX path and the offline decode.  The flax weights
are drawn from numpy and reach the port through ``params_from_flax``.
Adds the receptive-field case: at the 13-layer bench depth (±34 input
frames) the default 24 frames of context differ from the offline
forward, and 36 (34 rounded up to the ×3 grid) match it.
"""

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.am import tdnn as jtdnn
from kaldi_tpu.decoder.online_nnet import OnlineNnetScorer as JScorer
from kaldi_tpu_torch.am import tdnn as ttdnn
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer

torch.set_num_threads(1)


def random_tdnn(seed, **cfg):
    """(flax apply_fn, flax variables as numpy, port TdnnChain on the
    CPU) with the same weights: every parameter and batch statistic,
    the output layer included, drawn from numpy."""
    model = jtdnn.TdnnChain(jtdnn.TdnnConfig(**cfg))
    init = model.init(jax.random.PRNGKey(0),
                      np.zeros((1, 9, cfg["feat_dim"]), np.float32),
                      train=False)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = np.shape(leaf)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        scale = 1.0 / np.sqrt(shape[0]) if name == "kernel" else 0.2
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        draw, jax.tree_util.tree_map(np.asarray, dict(init)))
    net = ttdnn.TdnnChain(ttdnn.TdnnConfig(**cfg))
    net.load_state_dict(ttdnn.params_from_flax(variables))
    net.eval()

    @jax.jit
    def apply_fn(x):
        return model.apply(variables, x, train=False)

    return apply_fn, variables, net


def numpy_state(net, rng):
    """A seeded state dict for a port TdnnChain: N(0, 1/fan_in) weights,
    0.2·N(0, 1) biases and means, variances in [0.5, 1.5]."""
    sd = {}
    for k, v in net.state_dict().items():
        s = tuple(v.shape)
        if k.endswith("weight"):
            a = rng.standard_normal(s) / np.sqrt(s[1])
        elif k.endswith("var"):
            a = rng.uniform(0.5, 1.5, s)
        else:
            a = 0.2 * rng.standard_normal(s)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _streamed(scorer, feats, chunk):
    outs = []
    for i in range(0, len(feats), chunk):
        scorer.accept_features(feats[i:i + chunk])
        outs.append(np.asarray(scorer.read_new()))
    scorer.input_finished()
    outs.append(np.asarray(scorer.read_new()))
    return np.concatenate([o for o in outs if o.size])


SMALL = dict(feat_dim=8, num_pdfs=10, hidden_dim=16, bottleneck_dim=8,
             num_layers=3, frame_subsampling_factor=3)


@pytest.fixture(scope="module")
def small():
    return random_tdnn(7, **SMALL)


@pytest.mark.parametrize("chunk", [9, 30, 75])
def test_streaming_scores_match_jax_and_offline(small, chunk):
    apply_fn, _, net = small
    feats = np.random.default_rng(chunk).standard_normal(
        (150, 8)).astype(np.float32)
    got = _streamed(OnlineNnetScorer(net, device="cpu"), feats, chunk)
    want = _streamed(JScorer(apply_fn), feats, chunk)
    with torch.no_grad():
        offline = net(torch.from_numpy(feats)[None])[0].numpy()
    assert got.shape == want.shape == offline.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, offline, rtol=1e-5, atol=1e-5)


def test_the_last_subsampled_frame_is_emitted(small):
    """T = 151 input frames give ⌈151 / 3⌉ = 51 offline outputs: the port
    streams all 51 (the original stops at 50, the same 50)."""
    apply_fn, _, net = small
    feats = np.random.default_rng(5).standard_normal(
        (151, 8)).astype(np.float32)
    got = _streamed(OnlineNnetScorer(net, device="cpu"), feats, 40)
    want = _streamed(JScorer(apply_fn), feats, 40)
    with torch.no_grad():
        offline = net(torch.from_numpy(feats)[None])[0].numpy()
    assert got.shape[0] == offline.shape[0] == 51 and want.shape[0] == 50
    np.testing.assert_allclose(got, offline, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:50], want, rtol=1e-4, atol=1e-4)


def test_streaming_decode_with_online_scorer(rng):
    """Streamed TDNN scores through the dense streaming decoder equal
    the JAX path and the port's offline decode."""
    from kaldi_tpu.decoder.dense import DenseDecoder as JDense
    from kaldi_tpu.decoder.dense import DenseDecoderConfig as JCfg
    from kaldi_tpu.decoder.online import SingleUtteranceDecoder as JSingle
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    from test_torch_beam import JAX, PORT, yesno_graph
    _, tm, HCLG = yesno_graph(PORT, "chain", self_loop_scale=1.0)
    _, jtm, jHCLG = yesno_graph(JAX, "chain", self_loop_scale=1.0)
    apply_fn, _, net = random_tdnn(1, feat_dim=6, num_pdfs=tm.num_pdfs,
                                   hidden_dim=16, bottleneck_dim=8,
                                   num_layers=2, frame_subsampling_factor=3)
    feats = rng.standard_normal((120, 6)).astype(np.float32)
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=1e9, acoustic_scale=1.0),
                       device="cpu")
    jdec = JDense(jHCLG, jtm.tid_to_pdf_array,
                  JCfg(beam=1e9, acoustic_scale=1.0))
    with torch.no_grad():
        ref = dec.decode(net(torch.from_numpy(feats)[None])[0])
    results = []
    for online, sc in ((SingleUtteranceDecoder(dec, chunk_frames=8),
                        OnlineNnetScorer(net, device="cpu")),
                       (JSingle(jdec, chunk_frames=8), JScorer(apply_fn))):
        for i in range(0, len(feats), 25):
            sc.accept_features(feats[i:i + 25])
            s = np.asarray(sc.read_new())
            if s.size:
                online.advance_decoding(s)
        sc.input_finished()
        s = np.asarray(sc.read_new())
        if s.size:
            online.advance_decoding(s)
        results.append(online.get_best_path(use_final_probs=True))
    (tids, ols, cost), (jt, jo, jc) = results
    assert (tids, ols) == (jt, jo) == (ref[0], ref[1])
    assert abs(cost - jc) < 1e-3 and abs(cost - ref[2]) < 1e-3


def test_context_must_cover_the_receptive_field():
    """13 layers of strides [1, 1, 1] + [3] * 10: the receptive field is
    ±34 input frames, so 24 frames of context give scores that differ
    from the offline forward near the window edges, and 36 do not."""
    cfg = ttdnn.TdnnConfig(feat_dim=8, num_pdfs=10, hidden_dim=16,
                           bottleneck_dim=8, num_layers=13,
                           frame_subsampling_factor=3)
    assert 1 + sum(cfg.layer_strides()) == 34
    net = ttdnn.TdnnChain(cfg).eval()
    # N(0, 1/fan_in) weights: the far context reaches the output
    net.load_state_dict(numpy_state(net, np.random.default_rng(0)))
    feats = np.random.default_rng(2).standard_normal(
        (240, 8)).astype(np.float32)
    with torch.no_grad():
        offline = net(torch.from_numpy(feats)[None])[0].numpy()
    scale = np.abs(offline).max()
    err = {}
    for ctx in (24, 36):
        got = _streamed(OnlineNnetScorer(net, left_context=ctx,
                                         right_context=ctx, device="cpu"),
                        feats, 30)
        assert got.shape == offline.shape
        err[ctx] = np.abs(got - offline).max() / scale
    assert err[36] < 1e-6
    assert err[24] > 1e-4


def test_scorer_guards(small, monkeypatch):
    _, _, net = small
    sc = OnlineNnetScorer(net, device="cpu")
    assert tuple(sc.read_new().shape) == (0, 0)
    sc.accept_features(np.zeros((10, 8), np.float32))
    with pytest.raises(KaldiError, match="not ready"):
        sc.get_scores(0, 5)
    sc.input_finished()
    with pytest.raises(KaldiError, match="after input_finished"):
        sc.accept_features(np.zeros((3, 8), np.float32))
    import inspect
    assert inspect.signature(OnlineNnetScorer).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        OnlineNnetScorer(net)
