"""The port's GMM log-likelihoods against the JAX package.

``gmm_loglikes_reference`` (the CUDA kernel's plain version) is held to
``gmm_loglikes_xla`` and to the Pallas kernel in interpret mode at
rtol = atol = 1e-4, the bound of tests/test_pallas_ops.py: both sides
are float32 products summed in different orders.  The kernel's
parameter layout and its online logsumexp over mixture slots (with the
finite −1e30 sentinel of padded slots) are checked by a float32 numpy
walk of the same loop.  ``AmDiagGmm`` must compute the original's
natural parameters bit for bit.  The kernel itself runs only on a card
(the ``gpu`` test); the port's other objects run on the CPU
(``device="cpu"``).

The kernel's 3xTF32 arithmetic is checked in numpy (TF32 by a bit mask,
hi·hi + hi·lo + lo·hi): at the tri3b width and on the GMM path's
CMVN + Δ features it stays within 1e-4 + 1e-4·|plain| of the float32
plain version, where one TF32 product alone does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import gmm as jgmm
from kaldi_tpu.ops.pallas_gmm import gmm_loglikes_pallas, gmm_loglikes_xla
from kaldi_tpu_torch.am import gmm as tgmm
from kaldi_tpu_torch.ops.gmm import (MAX_DIM, NEG, TILE_P, CudaGmm,
                                     gmm_loglikes_reference, kernel_layout)
from kaldi_tpu_torch.ops.tf32 import round_tf32
from test_torch_features import product_3xtf32, product_tf32

torch.set_num_threads(1)


def _params(P, M, D, seed, padded):
    """Natural parameters as test_pallas_ops.py draws them; with
    ``padded``, each pdf keeps a seeded number of live slots and the
    rest carry the sentinel gconst (as a mixed-up model's do)."""
    rng = np.random.default_rng(seed)
    gconst = rng.standard_normal((P, M)).astype(np.float32)
    mi = rng.standard_normal((P, M, D)).astype(np.float32)
    iv = (0.5 + rng.random((P, M, D))).astype(np.float32)
    if padded:
        live = rng.integers(1, M + 1, P)
        dead = np.arange(M)[None, :] >= live[:, None]
        gconst[dead] = NEG
        mi[dead] = 0.0
        iv[dead] = 1.0
    x = rng.standard_normal((113, D)).astype(np.float32)
    return gconst, mi, iv, x


CASES = [(37, 6, 39, 100, False), (37, 6, 39, 77, True),
         (600, 4, 40, 300, True)]


@pytest.mark.parametrize("P,M,D,T,padded", CASES)
def test_reference_matches_xla_and_pallas(P, M, D, T, padded):
    gconst, mi, iv, x = _params(P, M, D, seed=P + T, padded=padded)
    x = np.resize(x, (T, D))
    xla = np.asarray(gmm_loglikes_xla(jnp.asarray(x), jnp.asarray(gconst),
                                      jnp.asarray(mi), jnp.asarray(iv)))
    pallas = np.asarray(gmm_loglikes_pallas(x, gconst, mi, iv,
                                            interpret=True))
    got = gmm_loglikes_reference(*(torch.from_numpy(a)
                                   for a in (x, gconst, mi, iv))).numpy()
    assert got.shape == (T, P)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


def _unpack(w, g, P, D):
    """kernel_layout's (w, g) → the hi and lo halves of W (M, K, P) and
    gconst (M, P): per pdf tile, slot and k-step, the hi then the lo
    tile as [pdf group][k half][pdf][k]."""
    NPT, M = w.shape[:2]
    KS = 2 * (-(-D // 8) * 8) // 8
    t = w.reshape(NPT, M, KS, 2, TILE_P // 8, 2, 8, 4)

    def flat(u):      # (NPT, M, KS, g, h, row, c) → (M, K, P)
        return u.permute(1, 2, 4, 6, 0, 3, 5).reshape(M, 8 * KS,
                                                      NPT * TILE_P)[..., :P]

    return (flat(t[:, :, :, 0]), flat(t[:, :, :, 1]),
            g.permute(1, 0, 2).reshape(M, -1)[:, :P])


def _walk_kernel(x, W, g):
    """The kernel's loop in float32 numpy on its layout: per slot m, the
    product [x | x²]·W_m (D zero-padded to Dp), + g, then the online
    (max, sum) update from the −1e30 sentinel with one exp per element
    (the larger term is exp(0))."""
    T, D = x.shape
    M, K, P = W.shape
    xt = np.zeros((T, K), np.float32)
    xt[:, :D] = x
    xt[:, K // 2:K // 2 + D] = x * x
    mx = np.full((T, P), np.float32(-1e30), np.float32)
    s = np.zeros((T, P), np.float32)
    for m in range(M):
        v = xt @ W[m] + g[m][None, :]
        d = np.exp(-np.abs(v - mx))
        up = v > mx
        s = np.where(up, s * d + 1.0, s + d).astype(np.float32)
        mx = np.where(up, v, mx)
    return mx + np.log(s)


@pytest.mark.parametrize("P,M,D,T,padded", CASES)
def test_kernel_layout_and_online_logsumexp(P, M, D, T, padded):
    gconst, mi, iv, x = _params(P, M, D, seed=P + T, padded=padded)
    x = np.resize(x, (T, D))
    w, g = kernel_layout(*(torch.from_numpy(v) for v in (gconst, mi, iv)))
    Dp = -(-D // 8) * 8
    NPT = -(-P // TILE_P)
    assert w.shape == (NPT, M, 2 * Dp // 8 * 1024) and w.is_contiguous()
    assert g.shape == (NPT, M, TILE_P) and g.is_contiguous()
    hi, lo, gg = _unpack(w, g, P, D)
    W = torch.zeros((M, 2 * Dp, P))
    W[:, :D] = torch.from_numpy(mi).permute(1, 2, 0)
    W[:, Dp:Dp + D] = torch.from_numpy(-0.5 * iv).permute(1, 2, 0)
    assert torch.equal(hi, round_tf32(W))
    assert torch.equal(lo, round_tf32(W - hi))
    assert not (hi[:, D:Dp].any() or hi[:, Dp + D:].any())
    np.testing.assert_array_equal(gg.numpy(), gconst.T)
    # pdfs past P carry the sentinel, so a ragged last tile stays finite
    if P % TILE_P:
        assert (g[-1, :, P % TILE_P:] == NEG).all()
    walked = _walk_kernel(x, (hi + lo).numpy(), gg.numpy())
    assert np.isfinite(walked).all()
    want = gmm_loglikes_reference(*(torch.from_numpy(v)
                                    for v in (x, gconst, mi, iv))).numpy()
    np.testing.assert_allclose(walked, want, rtol=1e-4, atol=1e-4)


def _path_model_and_feats():
    """The GMM path's CMVN + Δ features (MFCC at mini_librispeech's
    conf/mfcc.conf of speech rendered from a seeded pdf alignment) and a
    GMM of 30 pdfs with 12–13 Gaussians each drawn around them, as
    chip_smoke phase 6b draws its model."""
    from kaldi_tpu_torch.features import (Mfcc, MfccOptions, MelBanksOptions,
                                          add_deltas, apply_cmvn,
                                          compute_cmvn_stats)
    from kaldi_tpu_torch.tools.synth import (aligned_gmm, mix_counts,
                                             pdf_signatures, synth_speech)
    rng = np.random.default_rng(11)
    P = 30
    freqs, amps = pdf_signatures(rng, P, silent=[0])
    align = np.repeat(rng.integers(0, P, 40), rng.integers(4, 9, 40))
    mfcc = Mfcc(MfccOptions(mel_opts=MelBanksOptions(num_bins=23),
                            use_energy=False), device="cpu")
    raw = mfcc.compute(synth_speech(align, freqs, amps, rng))
    feats = add_deltas(apply_cmvn(raw, compute_cmvn_stats(raw))).numpy()
    am = aligned_gmm(rng, [feats], [align], mix_counts(rng, P, 375, 12, 13),
                     device="cpu")
    return am, feats


@pytest.mark.parametrize("which", ["tri3b", "path"])
def test_gmm_3xtf32_holds_where_tf32_does_not(which):
    """x̃ = [x | x²] times W = [μ/σ²; −½/σ²] in 3xTF32, + gconst,
    logsumexp over slots, against the float32 plain version: within
    1e-4 + 1e-4·|plain| at the tri3b width (log-likelihoods −90 to
    −460) and on the path's features; one TF32 product is not."""
    if which == "tri3b":
        from kaldi_tpu_torch.tools.synth import tri3b_gmm
        am = tri3b_gmm(np.random.default_rng(2), device="cpu")
        x = np.random.default_rng(3).standard_normal((40, 40)).astype(
            np.float32)
    else:
        am, x = _path_model_and_feats()
    g, mi, iv = am._natural_params()
    P, M, D = mi.shape
    W = np.concatenate([mi.reshape(P * M, D).T,
                        (-0.5 * iv).reshape(P * M, D).T])
    xt = np.concatenate([x, x * x], axis=1)
    want = gmm_loglikes_reference(*(torch.from_numpy(a)
                                    for a in (x, g, mi, iv))).numpy()
    assert want.max() < 0 and np.std(want) > 1.0
    excess = {}
    for name, product in (("3xtf32", product_3xtf32), ("tf32", product_tf32)):
        q = product(xt, W).reshape(-1, P, M) + g[None]
        top = q.max(axis=2, keepdims=True)
        ll = (top + np.log(np.exp(q - top).sum(axis=2, keepdims=True)))[..., 0]
        excess[name] = float((np.abs(ll - want)
                              / (1e-4 + 1e-4 * np.abs(want))).max())
    assert excess["3xtf32"] <= 1.0, excess
    assert excess["tf32"] > 1.0, excess


def test_wrapper_on_cpu_is_the_plain_version():
    gconst, mi, iv, x = _params(37, 6, 39, seed=5, padded=True)
    k = CudaGmm(gconst, mi, iv, device="cpu")
    got = k(torch.from_numpy(x))
    want = gmm_loglikes_reference(*(torch.from_numpy(v)
                                    for v in (x, gconst, mi, iv)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert k.launches == 0
    assert k.w is None          # the kernel layout is built for a card only


def test_wrapper_rejects_bad_input():
    gconst, mi, iv, x = _params(7, 3, 13, seed=1, padded=False)
    k = CudaGmm(gconst, mi, iv, device="cpu")
    with pytest.raises(ValueError):
        k(torch.zeros((4, 12)))
    with pytest.raises(TypeError):
        k(torch.zeros((4, 13), dtype=torch.float64))
    with pytest.raises(ValueError):
        CudaGmm(gconst, mi[:, :2], iv, device="cpu")
    # the kernel stages up to MAX_DIM dims in shared memory: a wider
    # model is refused when it is bound to a card, before any upload
    wide = np.zeros((7, 3, MAX_DIM + 1), np.float32)
    with pytest.raises(ValueError, match="feature dims"):
        CudaGmm(gconst, wide, wide + 1.0, device="cuda")


def _jax_model(P, M, D, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((P, M)) + 0.1
    w[rng.random((P, M)) < 0.3] = 0.0
    w[:, 0] = np.maximum(w[:, 0], 0.2)
    w /= w.sum(axis=1, keepdims=True)
    means = rng.standard_normal((P, M, D)) * 2.0
    variances = 0.3 + rng.random((P, M, D))
    return jgmm.AmDiagGmm(w, means, variances)


def test_natural_params_equal_jax():
    jam = _jax_model(19, 5, 13, seed=3)
    tam = tgmm.AmDiagGmm(jam.weights, jam.means, jam.vars, device="cpu")
    assert (tam.num_pdfs, tam.max_mix, tam.dim, tam.num_gauss()) == \
        (jam.num_pdfs, jam.max_mix, jam.dim, jam.num_gauss())
    for got, want in zip(tam._natural_params(), jam._natural_params()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [1, 64, 150])
def test_am_loglikes_matches_jax(T):
    jam = _jax_model(23, 6, 39, seed=T)
    tam = tgmm.AmDiagGmm(jam.weights, jam.means, jam.vars, device="cpu")
    feats = np.random.default_rng(T + 1).standard_normal(
        (T, 39)).astype(np.float32)
    want = np.asarray(jam.loglikes(feats))
    got = tam.loglikes(feats)
    assert got.dtype == torch.float32 and got.shape == (T, 23)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_am_device_cache_and_refresh():
    jam = _jax_model(5, 3, 4, seed=9)
    tam = tgmm.AmDiagGmm(jam.weights, jam.means, jam.vars, device="cpu")
    k = tam.device_params()
    assert tam.device_params() is k
    assert tam.to("cpu") is tam and tam.device_params() is k
    tam.means = tam.means + 1.0
    tam.refresh()
    k2 = tam.device_params()
    assert k2 is not k
    assert not torch.equal(k2.mean_invvar, k.mean_invvar)


@pytest.mark.gpu
def test_gmm_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gconst, mi, iv, _ = _params(2500, 10, 40, seed=2, padded=True)
    k = CudaGmm(gconst, mi, iv, device=dev)
    for T in (1, 300, 1000):
        x = torch.from_numpy(np.random.default_rng(T).standard_normal(
            (T, 40)).astype(np.float32)).to(dev)
        got = k(x)
        want = k.reference(x)
        torch.cuda.synchronize()
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    assert k.launches == 3


@pytest.mark.parametrize("lo,hi,total", [(2, 10, 600), (12, 13, 1000),
                                         (4, 6, 410)])
def test_mix_counts_are_uneven_and_exact(lo, hi, total):
    from kaldi_tpu_torch.tools.synth import mix_counts
    P = {600: 100, 1000: 82, 410: 82}[total]
    c = mix_counts(np.random.default_rng(total), P, total, lo, hi)
    assert c.sum() == total and c.min() >= lo and c.max() == hi
    assert len(np.unique(c)) > 1


def test_synth_speech_frames_follow_the_alignment():
    """One MFCC frame per aligned frame, and a GMM drawn around each
    pdf's frames scores the aligned pdf best on most frames."""
    from kaldi_tpu_torch.features import Mfcc, MfccOptions, MelBanksOptions
    from kaldi_tpu_torch.tools.synth import (aligned_gmm, mix_counts,
                                             pdf_signatures, synth_speech)
    rng = np.random.default_rng(4)
    P = 6
    freqs, amps = pdf_signatures(rng, P, silent=[0])
    align = np.repeat(rng.integers(0, P, 30), 8)
    wave = synth_speech(align, freqs, amps, rng)
    feats = Mfcc(MfccOptions(mel_opts=MelBanksOptions(num_bins=23),
                             use_energy=False), device="cpu").compute(wave)
    assert feats.shape == (len(align), 13)
    am = aligned_gmm(rng, [feats.numpy()], [align],
                     mix_counts(rng, P, 3 * P, 2, 4), device="cpu")
    hit = (am.loglikes(feats).argmax(dim=1).numpy() == align).mean()
    assert hit > 0.9


@pytest.mark.parametrize("shape", [(5,), (5, 3), (5, 3, 4)])
def test_sum_by_pdf_equals_index_add(shape):
    """am/gmm.py ``_sum_by_pdf`` (the accumulation's sums by pdf, sorted
    so that a card adds each pdf's frames in one order every run) equals
    ``index_add_`` on the CPU bit for bit: both add a pdf's frames in
    frame order there.  Pdfs that take no frame stay zero."""
    rng = np.random.default_rng(7)
    T, P = 97, shape[0]
    pdfs = torch.from_numpy(rng.choice([0, 1, 3], T).astype(np.int64))
    t = torch.from_numpy(rng.standard_normal((T,) + shape[1:]).astype(
        np.float32))
    got = tgmm._sum_by_pdf(t, pdfs, P)
    want = t.new_zeros((P,) + shape[1:]).index_add_(0, pdfs, t)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert not got[[2, 4]].any()


@pytest.mark.parametrize("threads", [2, 4])
def test_sum_by_pdf_is_one_order_on_many_threads(threads):
    """On the CPU with more than one torch thread, ``_sum_by_pdf`` gives
    the same bits every run, equal to its one-thread sums: the CPU's
    ``index_put_`` accumulate adds a large float32 tensor's frames with
    atomics from every thread, and the yesno training run on the CPU
    then ended at another loglike per frame each run."""
    rng = np.random.default_rng(8)
    T, P = 4000, 7
    pdfs = torch.from_numpy(rng.integers(0, P, T).astype(np.int64))
    t = torch.from_numpy(rng.standard_normal((T, 6, 13)).astype(
        np.float32))
    one = tgmm._sum_by_pdf(t, pdfs, P)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        runs = [tgmm._sum_by_pdf(t, pdfs, P) for _ in range(4)]
    finally:
        torch.set_num_threads(before)
    assert all(torch.equal(r, one) for r in runs)
