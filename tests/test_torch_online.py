"""PyTorch online features and SingleUtteranceDecoder against kaldi_tpu's
(CPU tensors).

Mirrors tests/test_online.py: streamed MFCC in chunks of 37, 160 and
1000 samples equals the JAX pipeline and the port's offline MFCC; the
deltas lag by their right context and match; the dense streaming
decoder equals the JAX one (partials too) at chunks of 7 and 32 frames
and the port's offline dense decode; endpointing answers the same.
Also online CMVN against the original's frame loop (within 1e-5), and
the i-vector and device guards.  Each side builds its yes/no graph with
its own package (tests/test_torch_beam.py ``yesno_graph``).
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder.dense import DenseDecoder as JDense
from kaldi_tpu.decoder.dense import DenseDecoderConfig as JDenseConfig
from kaldi_tpu.decoder.online import SingleUtteranceDecoder as JSingle
from kaldi_tpu.features import DeltaFeaturesOptions as JDeltaOpts
from kaldi_tpu.features import FrameExtractionOptions as JFrameOpts
from kaldi_tpu.features import Mfcc as JMfcc
from kaldi_tpu.features import MfccOptions as JMfccOpts
from kaldi_tpu.features import online as jonline
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
from kaldi_tpu_torch.features import (DeltaFeaturesOptions,
                                      FrameExtractionOptions, Mfcc,
                                      MfccOptions)
from kaldi_tpu_torch.features import online as tonline
from test_torch_beam import JAX, PORT, yesno_graph

torch.set_num_threads(1)


def _mfcc():
    return (Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0)),
                 device="cpu"),
            JMfcc(JMfccOpts(frame_opts=JFrameOpts(dither=0.0))))


def _stream(pipe, wave, chunk):
    for i in range(0, len(wave), chunk):
        pipe.accept_waveform(wave[i:i + chunk])
    pipe.input_finished()
    return pipe.get_frames(0, pipe.num_frames_ready())


@pytest.mark.parametrize("chunk", [37, 160, 1000])
def test_online_mfcc_matches_jax_and_offline(rng, chunk):
    wave = (rng.standard_normal(5000) * 100).astype(np.float32)
    mfcc, jmfcc = _mfcc()
    got = _stream(tonline.OnlineFeaturePipeline(mfcc), wave, chunk)
    want = _stream(jonline.OnlineFeaturePipeline(jmfcc), wave, chunk)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), mfcc.compute(wave).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_online_deltas_lag_and_match(rng):
    wave = (rng.standard_normal(4000) * 100).astype(np.float32)
    mfcc, jmfcc = _mfcc()
    pipe = tonline.OnlineFeaturePipeline(mfcc, deltas=DeltaFeaturesOptions())
    jpipe = jonline.OnlineFeaturePipeline(jmfcc, deltas=JDeltaOpts())
    for p in (pipe, jpipe):
        p.accept_waveform(wave[:2000])
    ready_mid = pipe.num_frames_ready()
    assert ready_mid == jpipe.num_frames_ready() > 0
    assert ready_mid == len(pipe._frames) - pipe.right_context
    got_mid = pipe.get_frames(0, ready_mid)
    np.testing.assert_allclose(got_mid.numpy(), jpipe.get_frames(0, ready_mid),
                               rtol=1e-3, atol=1e-3)
    got = _stream(pipe, wave[2000:], 4000)
    want = _stream(jpipe, wave[2000:], 4000)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    # frames far enough from the boundary do not change
    stable = ready_mid - pipe.right_context
    np.testing.assert_allclose(got[:stable].numpy(), got_mid[:stable].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_stats", [True, False])
def test_online_cmvn_matches_the_frame_loop(rng, with_stats):
    """Prefix-sum CMVN equals the original's per-frame loop within 1e-5,
    over a stream longer than the window."""
    T, D = 70, 5
    feats = (rng.standard_normal((T, D)) * 10 + 30).astype(np.float32)
    stats = None
    if with_stats:
        stats = np.zeros((2, D + 1))
        stats[0, :D] = rng.standard_normal(D) * 500
        stats[0, D] = 40.0
    o = tonline.OnlineCmvnOptions(cmn_window=25, global_stats=stats)
    jpipe = jonline.OnlineFeaturePipeline(
        None, cmvn=jonline.OnlineCmvnOptions(cmn_window=25,
                                             global_stats=stats))
    want = jpipe._apply_online_cmvn(feats)
    got = tonline.online_cmvn(torch.from_numpy(feats), o)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pipeline_with_cmvn_and_splice_matches_jax(rng):
    wave = (rng.standard_normal(6000) * 100).astype(np.float32)
    mfcc, jmfcc = _mfcc()
    stats = np.zeros((2, 14))
    stats[0, :13] = rng.standard_normal(13) * 50
    stats[0, 13] = 10.0
    got = _stream(tonline.OnlineFeaturePipeline(
        mfcc, cmvn=tonline.OnlineCmvnOptions(cmn_window=12,
                                             global_stats=stats),
        splice=(2, 2)), wave, 700)
    want = _stream(jonline.OnlineFeaturePipeline(
        jmfcc, cmvn=jonline.OnlineCmvnOptions(cmn_window=12,
                                              global_stats=stats),
        splice=(2, 2)), wave, 700)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_pipeline_guards():
    mfcc, _ = _mfcc()
    with pytest.raises(KaldiError, match="not ported"):
        tonline.OnlineFeaturePipeline(mfcc, ivector_estimator=object())
    with pytest.raises(KaldiError, match="not both"):
        tonline.OnlineFeaturePipeline(mfcc, deltas=DeltaFeaturesOptions(),
                                      splice=(1, 1))


def test_mfcc_pipeline_defaults_to_the_card(monkeypatch):
    import inspect
    assert inspect.signature(tonline.make_online_mfcc_pipeline).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        tonline.make_online_mfcc_pipeline()
    assert tonline.make_online_mfcc_pipeline(device="cpu").computer.device \
        == torch.device("cpu")


@pytest.fixture(scope="module")
def graphs():
    return {name: yesno_graph(side, "three_state")
            for name, side in (("port", PORT), ("jax", JAX))}


def _decoders(graphs, scale):
    _, tm, HCLG = graphs["port"]
    _, jtm, jHCLG = graphs["jax"]
    return (DenseDecoder(HCLG, tm.tid_to_pdf_array,
                         DenseDecoderConfig(beam=1e9, acoustic_scale=scale),
                         device="cpu"),
            JDense(jHCLG, jtm.tid_to_pdf_array,
                   JDenseConfig(beam=1e9, acoustic_scale=scale)))


@pytest.mark.parametrize("chunk", [7, 32])
def test_streaming_decoder_matches_jax_and_batch(graphs, chunk):
    dec, jdec = _decoders(graphs, 0.1)
    T = 50
    ll = np.random.default_rng(0).standard_normal(
        (T, graphs["port"][1].num_pdfs)).astype(np.float32)
    ref_tids, ref_ols, ref_cost = dec.decode(ll)
    online = SingleUtteranceDecoder(dec, chunk_frames=chunk)
    jon = JSingle(jdec, chunk_frames=chunk)
    for i in range(0, T, 13):
        online.advance_decoding(ll[i:i + 13])
        jon.advance_decoding(ll[i:i + 13])
        # partial results at any time, equal to the JAX decoder's
        tids, ols, cost = online.get_best_path()
        jt, jo, jc = jon.get_best_path()
        assert len(tids) == online.num_frames_decoded == jon.num_frames_decoded
        assert (tids, ols) == (jt, jo) and abs(cost - jc) < 1e-3
    tids, ols, cost = online.get_best_path(use_final_probs=True)
    assert tids == ref_tids and ols == ref_ols and abs(cost - ref_cost) < 1e-3
    jt, jo, jc = jon.get_best_path(use_final_probs=True)
    assert (tids, ols) == (jt, jo) and abs(cost - jc) < 1e-3


def test_endpointing_matches_jax(graphs):
    lang, tm, _ = graphs["port"]
    jlang, jtm, _ = graphs["jax"]
    dec, jdec = _decoders(graphs, 1.0)
    rng = np.random.default_rng(1)
    sil, jsil = lang.phones["SIL"], jlang.phones["SIL"]
    online = SingleUtteranceDecoder(dec, chunk_frames=16,
                                    silence_phones={sil}, trans_model=tm)
    jon = JSingle(jdec, chunk_frames=16, silence_phones={jsil},
                  trans_model=jtm)
    # plant: YES then long silence
    favored = []
    for ph in ["Y", "EH", "S"]:
        for st in range(3):
            favored.extend([tm.tree.compute([lang.phones[ph]], st)] * 4)
    favored.extend([tm.tree.compute([sil], st)
                    for st in range(3) for _ in range(30)])
    ll = rng.standard_normal((len(favored), tm.num_pdfs)).astype(np.float32)
    for t, p in enumerate(favored):
        ll[t, p] += 10.0
    for o in (online, jon):
        o.advance_decoding(ll[:20])
    assert not online.endpoint_detected()        # still in speech
    assert not jon.endpoint_detected()
    for o in (online, jon):
        o.advance_decoding(ll[20:])
    assert online.trailing_silence_frames() == jon.trailing_silence_frames()
    assert online.trailing_silence_frames() >= 50
    assert online.endpoint_detected() and jon.endpoint_detected()
