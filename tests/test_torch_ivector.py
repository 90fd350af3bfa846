"""The port's am/ivector.py against kaldi_tpu's, on CPU tensors in float64.

Mirrors tests/test_ivector.py (VAD, speaker separation, online
convergence, PLDA, clustering, diarization, the batched online i-vectors
against the streaming estimator, the diag UBM), and holds every port
result against the JAX package's on the same seeded numpy inputs at
1e-9 relative to the largest magnitude (both compute in float64; only
summation order differs).  Also: the same random draws (the UBM's frame
and mean choice, T's initialiser), ``em_update``'s skipped Gaussians,
the batched ``em_stats`` against the original's loop, ``max_count``
per checkpoint, ``from_am`` on the port's ``AmDiagGmm``, and the
extractor file byte for byte in both directions.
"""

import numpy as np
import pytest
import torch

import kaldi_tpu.am.ivector as J
import kaldi_tpu_torch.am.ivector as P
from kaldi_tpu.am.gmm import AmDiagGmm as JAmDiagGmm
from kaldi_tpu_torch.am.gmm import AmDiagGmm as TAmDiagGmm

torch.set_num_threads(1)

REL = 1e-9


def close(got, want, rel=REL):
    """|got − want| ≤ rel · max|want| elementwise (float64 both)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, (err, scale)


def pair(ubm_means, ubm_vars, weights, K, seed=0):
    return (P.IvectorExtractor(ubm_means, ubm_vars, weights, K, seed=seed,
                               device="cpu"),
            J.IvectorExtractor(ubm_means, ubm_vars, weights, K, seed=seed))


@pytest.mark.parametrize("ctx", [0, 3])
def test_vad_energy_matches_jax(rng, ctx):
    T, D = 100, 10
    feats = rng.standard_normal((T, D)).astype(np.float32)
    feats[:, 0] = 0.0
    feats[40:60, 0] = 20.0      # loud segment
    opts = P.VadEnergyOptions(vad_frames_context=ctx)
    got = P.compute_vad_energy(feats, opts, device="cpu")
    want = J.compute_vad_energy(feats, J.VadEnergyOptions(
        vad_frames_context=ctx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[45] == 1.0 and got[10] == 0.0
    assert 15 <= float(got.sum()) <= 25 + 2 * ctx


def _speaker_world(rng, n_spk=4, utts_per_spk=6, frames=200, D=8, K=3):
    """Synthetic speakers: shared UBM + per-speaker offset in a K-dim
    subspace — exactly the total-variability generative model."""
    G = 6
    ubm_means = rng.standard_normal((G, D)) * 4
    ubm_vars = 0.4 + 0.3 * rng.random((G, D))
    weights = np.ones(G) / G
    T_true = rng.standard_normal((G, D, K))
    data = {}
    for s in range(n_spk):
        w = rng.standard_normal(K) * 1.5
        utts = []
        for _ in range(utts_per_spk):
            comps = rng.integers(0, G, frames)
            x = (ubm_means[comps] + np.einsum("gdk,k->gd", T_true, w)[comps]
                 + np.sqrt(ubm_vars[comps]) * rng.standard_normal((frames, D)))
            utts.append(x)
        data[f"spk{s}"] = utts
    return ubm_means, ubm_vars, weights, data


def test_ivector_extraction_separates_speakers(rng):
    ubm_means, ubm_vars, weights, data = _speaker_world(rng)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3)
    close(ex.T, jex.T, 0.0)                      # the same draws
    stats = [ex.acc_stats(u) for utts in data.values() for u in utts]
    jstats = [jex.acc_stats(u) for utts in data.values() for u in utts]
    for (g, x), (jg, jx) in zip(stats, jstats):
        close(g, jg)
        close(x, jx)
    ex.train(stats, num_iters=3)
    jex.train(jstats, num_iters=3)
    close(ex.T, jex.T)

    ivs = {spk: torch.stack([ex.extract_from_feats(u) for u in utts]).numpy()
           for spk, utts in data.items()}
    for spk, utts in data.items():
        close(ivs[spk], np.stack([jex.extract_from_feats(u) for u in utts]))
    within, between = [], []
    spks = sorted(ivs)
    for s in spks:
        m = ivs[s].mean(axis=0)
        within.extend(np.linalg.norm(ivs[s] - m, axis=1))
    for i in range(len(spks)):
        for j in range(i + 1, len(spks)):
            between.append(np.linalg.norm(ivs[spks[i]].mean(0)
                                          - ivs[spks[j]].mean(0)))
    assert np.mean(between) > 2.0 * np.mean(within)


def test_em_stats_batch_equals_the_loop(rng):
    """``em_stats`` over all utterances at once equals the original's
    per-utterance loop (A, B and tot_gamma), with silence-weighted
    stats among them."""
    ubm_means, ubm_vars, weights, data = _speaker_world(rng, n_spk=2,
                                                        utts_per_spk=3)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3, seed=5)
    utts = [u for v in data.values() for u in v]
    wts = [None if i % 2 else rng.random(len(u)) for i, u in
           enumerate(utts)]
    got = ex.em_stats([ex.acc_stats(u, w) for u, w in zip(utts, wts)])
    want = jex.em_stats([jex.acc_stats(u, w) for u, w in zip(utts, wts)])
    for g, w in zip(got, want):
        close(g, w)
    empty = ex.em_stats([])
    assert [tuple(t.shape) for t in empty] == [(6, 3, 3), (6, 8, 3), (6,)]


def test_em_update_keeps_skipped_gaussians(rng):
    """Gaussians with tot_gamma < 1e-3 keep their old T; the rest take
    the batched solve, equal to the original's per-Gaussian solves."""
    ubm_means, ubm_vars, weights, data = _speaker_world(rng, n_spk=2,
                                                        utts_per_spk=2)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3, seed=2)
    stats = [jex.acc_stats(u) for v in data.values() for u in v]
    A, B, tot = jex.em_stats(stats)
    tot = tot.copy()
    tot[[1, 4]] = [5e-4, 0.0]
    A[4] = 0.0                  # an empty accumulator must not fail
    before = ex.T.clone()
    ex.em_update(A, B, tot)
    jex.em_update(A, B, tot)
    close(ex.T, jex.T)
    assert torch.equal(ex.T[1], before[1]) and torch.equal(ex.T[4], before[4])
    assert not torch.equal(ex.T[0], before[0])


def test_online_ivector_converges(rng):
    ubm_means, ubm_vars, weights, data = _speaker_world(rng, n_spk=1,
                                                        utts_per_spk=1,
                                                        frames=600)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3)
    utt = data["spk0"][0]
    offline = ex.extract_from_feats(utt)
    close(offline, jex.extract_from_feats(utt))
    online = P.OnlineIvectorEstimator(ex)
    jonline = J.OnlineIvectorEstimator(jex)
    partials = []
    for i in range(0, 600, 100):
        online.accept_frames(utt[i:i + 100])
        jonline.accept_frames(utt[i:i + 100])
        partials.append(online.ivector())
        close(partials[-1], jonline.ivector())
    assert online.num_frames == jonline.num_frames == 600
    np.testing.assert_allclose(partials[-1].numpy(), offline.numpy(),
                               atol=1e-6)
    d_early = float(torch.linalg.norm(partials[0] - offline))
    d_late = float(torch.linalg.norm(partials[-2] - offline))
    assert d_late <= d_early + 1e-9


@pytest.mark.parametrize("max_count", [0.0, 150.0])
def test_online_estimator_weights_and_max_count_match_jax(rng, max_count):
    """Frame weights at accept time, revised weights (a delta over the
    revised frames) and the max_count cap give the original's estimate."""
    ubm_means, ubm_vars, weights, data = _speaker_world(rng, n_spk=1,
                                                        utts_per_spk=1)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3)
    x = data["spk0"][0]
    est = P.OnlineIvectorEstimator(ex, max_count=max_count)
    jest = J.OnlineIvectorEstimator(jex, max_count=max_count)
    w0 = rng.random(80)
    for e in (est, jest):
        e.accept_frames(x[:80], w0)
        e.accept_frames(x[80:150])
    close(est.ivector(), jest.ivector())
    revised = np.r_[np.zeros(30), 0.5 * np.ones(100)]
    est.update_frame_weights(revised)
    jest.update_frame_weights(revised)
    close(est.gamma, jest.gamma)
    close(est.X, jest.X)
    close(est.ivector(), jest.ivector())
    # weights longer than the frames seen revise only those frames
    est.update_frame_weights(np.ones(400))
    jest.update_frame_weights(np.ones(400))
    close(est.ivector(), jest.ivector())


def test_plda_scoring(rng):
    ubm_means, ubm_vars, weights, data = _speaker_world(
        rng, n_spk=5, utts_per_spk=8)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3)
    ivs = {spk: torch.stack([ex.extract_from_feats(u)
                             for u in utts]).numpy()
           for spk, utts in data.items()}
    jivs = {spk: np.stack([jex.extract_from_feats(u) for u in utts])
            for spk, utts in data.items()}
    for s in ivs:
        close(ivs[s], jivs[s])
    train_ivs = {s: v[:5] for s, v in ivs.items()}
    plda = P.Plda.train(train_ivs)
    jplda = J.Plda.train({s: v[:5] for s, v in jivs.items()})
    close(plda.transform, jplda.transform, 1e-6)
    same, diff = [], []
    spks = sorted(ivs)
    for s in spks:
        enroll = ivs[s][:5].mean(axis=0)
        for t in spks:
            for test in ivs[t][5:]:
                score = plda.score(enroll, test, n_train=5)
                want = jplda.score(jivs[s][:5].mean(axis=0), test,
                                   n_train=5)
                assert abs(score - want) <= 1e-6 * max(abs(want), 1.0)
                (same if s == t else diff).append(score)
    assert np.mean(same) > np.mean(diff) + 1.0
    same_a = np.asarray(same)[:, None]
    diff_a = np.asarray(diff)[None, :]
    auc = float((same_a > diff_a).mean())
    assert auc > 0.9, auc


def test_agglomerative_cluster_exact():
    """Hand-built similarity matrix: {0,1} and {2,3} are mutually
    similar, cross scores far below threshold → exactly two clusters."""
    S = np.array([[0, 5, -9, -9],
                  [5, 0, -9, -9],
                  [-9, -9, 0, 4],
                  [-9, -9, 4, 0]], float)
    for kw, want in ((dict(threshold=0.0), [0, 0, 1, 1]),
                     (dict(threshold=0.0, max_clusters=1), [0, 0, 0, 0]),
                     (dict(threshold=-100.0, min_clusters=4),
                      [0, 1, 2, 3])):
        got = P.agglomerative_cluster(S, **kw)
        assert got.tolist() == J.agglomerative_cluster(S, **kw).tolist()
        assert sorted(got.tolist()) == sorted(want)
    assert P.agglomerative_cluster(np.zeros((0, 0)), 0.0).shape == (0,)


def test_diarization_recovers_speakers(rng):
    """PLDA + AHC diarization on the port's i-vectors recovers planted
    speaker turns, with the original's labels."""
    ubm_means, ubm_vars, weights, data = _speaker_world(
        rng, n_spk=6, utts_per_spk=10)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3)
    ivs = {spk: torch.stack([ex.extract_from_feats(u)
                             for u in utts]).numpy()
           for spk, utts in data.items()}
    spks = sorted(ivs)
    plda = P.Plda.train({s: ivs[s] for s in spks[:4]})
    segs, truth = [], []
    for k, s in enumerate(spks[4:]):
        for iv in ivs[s]:
            segs.append(iv)
            truth.append(k)
    segs = np.stack(segs)
    labels = P.diarize(plda, segs, threshold=0.0, max_clusters=2)
    jlabels = J.diarize(J.Plda.train({s: ivs[s] for s in spks[:4]}), segs,
                        threshold=0.0, max_clusters=2)
    assert labels.tolist() == jlabels.tolist()
    truth = np.asarray(truth)
    assert len(set(labels.tolist())) == 2
    agree = max(float((labels == truth).mean()),
                float((labels == 1 - truth).mean()))
    assert agree > 0.9, (labels, truth)


@pytest.mark.parametrize("period,max_count,T", [
    (10, 0.0, 64), (10, 100.0, 64), (7, 20.0, 64), (10, 0.0, 10),
    (10, 0.0, 5), (16, 0.0, 0)])
def test_online_ivectors_batched_matches_streaming(rng, period, max_count,
                                                   T):
    """The batched online_ivectors equals the original's loop, and (with
    max_count off) the frame-at-a-time OnlineIvectorEstimator at every
    period checkpoint, converging toward the utterance-level estimate."""
    G, D, K = 8, 6, 3
    ubm_m = rng.standard_normal((G, D)) * 3
    ubm_v = 0.5 + 0.2 * rng.random((G, D))
    w = np.ones(G) / G
    ex, jex = pair(ubm_m, ubm_v, w, K)
    x = (ubm_m[rng.integers(0, G, T)]
         + rng.standard_normal((T, D))).astype(np.float64)
    out = P.online_ivectors(ex, x, period=period, max_count=max_count)
    close(out, J.online_ivectors(jex, x, period=period, max_count=max_count))
    assert out.shape == (T, K) and out.dtype == torch.float64
    assert torch.all(out[:period] == 0.0)      # prior before any stats
    if max_count or T == 0:
        return
    est = P.OnlineIvectorEstimator(ex)
    for t0 in range(0, T, period):
        want = est.ivector() if t0 else torch.zeros(K, dtype=torch.float64)
        np.testing.assert_allclose(out[t0].numpy(), want.numpy(), atol=1e-6)
        est.accept_frames(x[t0:t0 + period])
    np.testing.assert_allclose(est.ivector().numpy(),
                               ex.extract_from_feats(x).numpy(), atol=1e-8)


@pytest.mark.parametrize("kw", [dict(num_gauss=3, num_iters=10, seed=1),
                                dict(num_gauss=5, num_iters=3, seed=4,
                                     max_frames=500)])
def test_train_diag_ubm_recovers_clusters(rng, kw):
    """The same frame and mean draws, then the same EM in float64; the
    learned means sit on the planted centers."""
    centers = np.array([[5.0, 0.0], [-5.0, 0.0], [0.0, 6.0]])
    X = np.concatenate([c + 0.3 * rng.standard_normal((400, 2))
                        for c in centers])
    rng.shuffle(X)
    parts = [X[:700], X[700:]]
    got = P.train_diag_ubm(parts, device="cpu", **kw)
    want = J.train_diag_ubm(parts, **kw)
    for g, w in zip(got, want):
        close(g, w)
    m, _, w = (t.numpy() for t in got)
    if kw["num_gauss"] == 3:
        for c in centers:
            assert np.min(np.linalg.norm(m - c, axis=1)) < 0.5
        assert np.all(w > 0.2)


def test_from_am_matches_jax(rng):
    """A trained one-pdf diag GMM (the port's AmDiagGmm and the
    original's, same parameters, one zero-weight slot) gives the same
    extractor."""
    M, D = 5, 4
    wts = rng.random((1, M))
    wts[0, 2] = 0.0
    wts /= wts.sum()
    means = rng.standard_normal((1, M, D))
    var = 0.5 + rng.random((1, M, D))
    ex = P.IvectorExtractor.from_am(TAmDiagGmm(wts, means, var,
                                               device="cpu"), 4)
    jex = J.IvectorExtractor.from_am(JAmDiagGmm(wts, means, var), 4)
    assert ex.device.type == "cpu" and ex.means.shape == (4, D)
    for name in ("means", "inv_vars", "weights", "T"):
        close(getattr(ex, name), getattr(jex, name), 0.0)


def test_extractor_file_round_trips_between_packages(rng, tmp_path):
    """The port writes the original's bytes, reads the original's files,
    and a file read by either package writes back the same bytes."""
    ubm_means, ubm_vars, weights, data = _speaker_world(rng, n_spk=1,
                                                        utts_per_spk=2)
    ex, jex = pair(ubm_means, ubm_vars, weights, 3, seed=9)
    P.write_ivector_extractor(str(tmp_path / "port.ie"), ex)
    J.write_ivector_extractor(str(tmp_path / "jax.ie"), jex)
    assert (tmp_path / "port.ie").read_bytes() == \
        (tmp_path / "jax.ie").read_bytes()
    back = P.read_ivector_extractor(str(tmp_path / "jax.ie"), device="cpu")
    jback = J.read_ivector_extractor(str(tmp_path / "port.ie"))
    for name in ("means", "inv_vars", "weights", "T"):
        close(getattr(back, name), getattr(jback, name), 0.0)
    assert back.ivector_dim == jback.ivector_dim == 3
    P.write_ivector_extractor(str(tmp_path / "port2.ie"), back)
    J.write_ivector_extractor(str(tmp_path / "jax2.ie"), jback)
    assert (tmp_path / "port2.ie").read_bytes() == \
        (tmp_path / "jax2.ie").read_bytes()
    u = data["spk0"][0]
    close(back.extract_from_feats(u), jback.extract_from_feats(u))


def test_plda_file_round_trips_between_packages(rng, tmp_path):
    ivs = {f"s{i}": rng.standard_normal((4, 3)) + i for i in range(3)}
    plda, jplda = P.Plda.train(ivs), J.Plda.train(ivs)
    P.write_plda(str(tmp_path / "p"), plda)
    J.write_plda(str(tmp_path / "j"), jplda)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    back = P.read_plda(str(tmp_path / "j"))
    close(back.within, J.read_plda(str(tmp_path / "p")).within, 0.0)
