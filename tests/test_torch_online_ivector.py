"""Online i-vectors and silence weighting in the port's streaming pipeline
(features/online.py with am/ivector.py) against kaldi_tpu's, on CPU
tensors.

Mirrors tests/test_online_ivector.py:
  * streamed-in-chunks == streamed-in-one-shot feature matrices with
    i-vectors appended, and both equal the JAX pipeline's (MFCC columns
    within 1e-4 as tests/test_torch_online.py holds them; the float32
    i-vector columns within 1e-5 relative to their largest magnitude);
  * per-block i-vectors are causal re-estimates every ivector_period,
    equal to direct extraction from the raw frames up to the boundary;
  * silence weighting: revised frame weights change the estimate exactly
    as direct weighted extraction does (1e-9 relative against the JAX
    estimator, float64 both);
  * OnlineSilenceWeighting gives the original's weights from a tid
    traceback;
  * end to end: the port's TdnnChain scores on i-vector features read
    after every chunk equal the offline scores on the assembled matrix
    of those reads, and the JAX model's (the same weights through
    ``params_from_flax``); the reads equal the JAX pipeline's.  (Reading
    frames feeds the estimator every frame so far, as the original does,
    so the next blocks' i-vectors differ from a pipeline read once at
    the end.)
"""

import numpy as np
import pytest
import torch

import kaldi_tpu.am.ivector as J
import kaldi_tpu_torch.am.ivector as P
from kaldi_tpu.features import FrameExtractionOptions as JFrameOpts
from kaldi_tpu.features import Mfcc as JMfcc
from kaldi_tpu.features import MfccOptions as JMfccOpts
from kaldi_tpu.features.online import OnlineFeaturePipeline as JPipeline
from kaldi_tpu_torch.features import FrameExtractionOptions, Mfcc, MfccOptions
from kaldi_tpu_torch.features.online import OnlineFeaturePipeline

torch.set_num_threads(1)

K = 5


def _extractors(rng, dim=13, n_gauss=8, ivec_dim=K):
    means = rng.standard_normal((n_gauss, dim)) * 2
    var = np.ones((n_gauss, dim))
    w = np.ones(n_gauss) / n_gauss
    return (P.IvectorExtractor(means, var, w, ivec_dim, device="cpu"),
            J.IvectorExtractor(means, var, w, ivec_dim))


def _pipe(ex):
    opts = MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0))
    return OnlineFeaturePipeline(
        Mfcc(opts, device="cpu"),
        ivector_estimator=P.OnlineIvectorEstimator(ex), ivector_period=10)


def _jpipe(jex):
    opts = JMfccOpts(frame_opts=JFrameOpts(dither=0.0))
    return JPipeline(JMfcc(opts),
                     ivector_estimator=J.OnlineIvectorEstimator(jex),
                     ivector_period=10)


def _feed(pipe, wave, chunk):
    for i in range(0, len(wave), chunk):
        pipe.accept_waveform(wave[i:i + chunk])
    pipe.input_finished()
    return pipe.get_frames(0, pipe.num_frames_ready())


def _same_features(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got[:, :-K], want[:, :-K], rtol=1e-4,
                               atol=1e-4)
    iv = want[:, -K:]
    assert np.abs(got[:, -K:] - iv).max() <= 1e-5 * np.abs(iv).max()


@pytest.mark.parametrize("chunk", [500, 1600])
def test_streamed_ivector_features_match(rng, chunk):
    ex, jex = _extractors(rng)
    wave = (rng.standard_normal(8000) * 100).astype(np.float32)
    ref = _feed(_pipe(ex), wave, len(wave))
    got = _feed(_pipe(ex), wave, chunk)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == ref.shape and got.shape[1] == 13 + K
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    _same_features(got, _feed(_jpipe(jex), wave, chunk))
    ivecs = ref[:, -K:]
    assert float((ivecs[0] - ivecs[-1]).abs().max()) > 1e-6


def test_ivector_blocks_causal(rng):
    """Block k's i-vector equals direct extraction from the raw frames
    seen up to its boundary, and is what its frames carry."""
    ex, jex = _extractors(rng)
    pipe = _pipe(ex)
    wave = (rng.standard_normal(6000) * 100).astype(np.float32)
    pipe.accept_waveform(wave)
    pipe.input_finished()
    n = pipe.num_frames_ready()
    out = pipe.get_frames(0, n)
    raw = pipe._frames
    assert len(pipe._ivectors) == n // pipe.ivector_period
    for block in range(len(pipe._ivectors)):
        boundary = (block + 1) * pipe.ivector_period
        direct = ex.extract_from_feats(raw[:boundary])
        np.testing.assert_allclose(pipe._ivectors[block].numpy(),
                                   direct.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            pipe._ivectors[block].numpy(),
            jex.extract_from_feats(raw[:boundary].numpy()), rtol=1e-4,
            atol=1e-5)
        t = block * pipe.ivector_period
        np.testing.assert_array_equal(out[t, -K:].numpy(),
                                      pipe._ivectors[block].numpy())
    # frames past the last complete block carry the current estimate
    np.testing.assert_allclose(out[-1, -K:].numpy(),
                               ex.extract_from_feats(raw).float().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_silence_weighting_changes_estimate(rng):
    ex, jex = _extractors(rng)
    est = P.OnlineIvectorEstimator(ex)
    jest = J.OnlineIvectorEstimator(jex)
    feats = rng.standard_normal((40, 13)) * 2
    est.accept_frames(feats)
    jest.accept_frames(feats)
    iv_unweighted = est.ivector()
    # decoder says the first 20 frames were silence
    weights = np.concatenate([np.zeros(20), np.ones(20)])
    pipe = OnlineFeaturePipeline(Mfcc(device="cpu"), ivector_estimator=est)
    pipe.set_frame_weights(weights)
    jest.update_frame_weights(weights)
    iv_weighted = est.ivector()
    want = jest.ivector()
    assert np.abs(iv_weighted.numpy() - want).max() <= \
        1e-9 * np.abs(want).max()
    direct = ex.extract(*ex.acc_stats(feats, weights=weights))
    np.testing.assert_allclose(iv_weighted.numpy(), direct.numpy(),
                               rtol=1e-6, atol=1e-8)
    assert float((iv_weighted - iv_unweighted).abs().max()) > 1e-6
    # restoring the weights restores the estimate (delta updates exact)
    est.update_frame_weights(np.ones(40))
    np.testing.assert_allclose(est.ivector().numpy(), iv_unweighted.numpy(),
                               rtol=1e-6, atol=1e-8)


def test_silence_weighting_from_traceback(rng):
    from kaldi_tpu_torch.am.topology import HmmTopology
    from kaldi_tpu_torch.am.transitions import TransitionModel
    from kaldi_tpu_torch.am.tree import MonophoneContextDependency
    phones = [1, 2, 3]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    tm = TransitionModel(topo, tree)
    sil = {1}

    def tids_for(phone, dur):
        st = topo.topology_for_phone(phone)[0]
        window = [phone]
        fwd = tree.compute(window, st.forward_pdf_class)
        slf = tree.compute(window, st.self_loop_pdf_class)
        ts = tm.tuple_to_transition_state(phone, 0, fwd, slf)
        fwd_tid = [tm.pair_to_transition_id(ts, i)
                   for i, (ns, _) in enumerate(st.transitions) if ns != 0][0]
        self_tid = tm.self_loop_of(ts)
        return [fwd_tid] + [self_tid] * (dur - 1)

    tb = tids_for(1, 4) + tids_for(2, 6)
    sw = P.OnlineSilenceWeighting(tm, sil, silence_weight=0.1)
    w = sw.compute_weights(tb, 12)
    np.testing.assert_allclose(w[:4], 0.1)
    np.testing.assert_allclose(w[4:10], 1.0)
    np.testing.assert_allclose(w[10:], 1.0)   # undecoded frames default
    np.testing.assert_array_equal(
        w, J.OnlineSilenceWeighting(tm, sil, 0.1).compute_weights(tb, 12))


def test_streamed_scores_with_ivectors(rng):
    """End to end: TdnnChain scoring streamed over i-vector-appended
    features, read after every chunk as online2 reads them, equals the
    offline scoring of the assembled matrix of those reads; the reads
    equal the JAX pipeline's, and the JAX model's offline scores (the
    same weights) equal the port's."""
    from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer
    from test_torch_online_nnet import random_tdnn

    ex, jex = _extractors(rng)
    wave = (rng.standard_normal(9600) * 100).astype(np.float32)
    D = 13 + K
    apply_fn, _, net = random_tdnn(3, feat_dim=D, num_pdfs=6, hidden_dim=16,
                                   bottleneck_dim=4, num_layers=2,
                                   frame_subsampling_factor=3)
    scorer = OnlineNnetScorer(net, left_context=12, right_context=12,
                              subsample=3, device="cpu")
    pipe, jpipe = _pipe(ex), _jpipe(jex)
    emitted = 0
    reads, jreads, chunks = [], [], []

    def read(ready):
        reads.append(pipe.get_frames(emitted, ready))
        jreads.append(jpipe.get_frames(emitted, ready))
        scorer.accept_features(reads[-1])

    for i in range(0, len(wave), 1600):
        pipe.accept_waveform(wave[i:i + 1600])
        jpipe.accept_waveform(wave[i:i + 1600])
        ready = pipe.num_frames_ready()
        assert ready == jpipe.num_frames_ready()
        if ready > emitted:
            read(ready)
            emitted = ready
        chunks.append(scorer.read_new())
    pipe.input_finished()
    jpipe.input_finished()
    ready = pipe.num_frames_ready()
    if ready > emitted:
        read(ready)
    scorer.input_finished()
    chunks.append(scorer.read_new())
    feats = torch.cat(reads)
    _same_features(feats, np.concatenate(jreads))
    with torch.no_grad():
        offline = net(feats[None])[0].numpy()
    np.testing.assert_allclose(
        offline, np.asarray(apply_fn(feats.numpy()[None])[0]), rtol=1e-3,
        atol=1e-3)
    got = torch.cat([c for c in chunks if c.numel()]).numpy()
    assert got.shape[0] >= offline.shape[0] - 1
    np.testing.assert_allclose(got, offline[:got.shape[0]], rtol=1e-3,
                               atol=1e-3)
