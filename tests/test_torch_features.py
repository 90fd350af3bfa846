"""PyTorch port's feature frontend against the JAX package.

The same seeded numpy inputs go through kaldi_tpu and kaldi_tpu_torch:
mel banks and framing must be equal bit for bit; the fbank kernel's
plain PyTorch version must match ``fbank_xla`` (same products, float32
summation order differs: atol 1e-4) and the Pallas kernel in interpret
mode (atol 2e-3, the repo's own bound for that kernel); the port's
``Fbank`` (DFT by products) must match the JAX ``Fbank`` (rfft) at
atol 2e-3 on non-silent frames.  The port runs on the CPU
(``device="cpu"``).

The kernel's own arithmetic is checked in numpy: TF32 rounding by a bit
mask (to nearest, ties away, as ``cvt.rna``), the 3xTF32 sum
hi·hi + hi·lo + lo·hi on the path's waveforms within 2e-3 log-mel of
the float32 plain version, where one TF32 product alone is not; and its
layout: mel filter groups that cover every nonzero of the mel matrix,
and an fbank computed group by group from the interleaved, split tables
equal to ``fbank_reference``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.features import compute as jcompute
from kaldi_tpu.features import mel as jmel
from kaldi_tpu.features import window as jwindow
from kaldi_tpu.ops.pallas_frontend import (PallasFbank, _dft_matrices,
                                           fbank_xla)
from kaldi_tpu_torch.features import compute as tcompute
from kaldi_tpu_torch.features import mel as tmel
from kaldi_tpu_torch.features import window as twindow
from kaldi_tpu_torch.ops import fbank as tfbank
from kaldi_tpu_torch.ops.fbank import CudaFbank, dft_matrices, \
    fbank_reference
from kaldi_tpu_torch.ops.tf32 import from_fragment_order, round_tf32

torch.set_num_threads(1)


def _frame_opts(mod, **kw):
    return mod.FrameExtractionOptions(**kw)


@pytest.mark.parametrize("num_bins,warp", [(23, 1.0), (40, 1.0), (40, 0.9)])
def test_mel_banks_equal(num_bins, warp):
    jb = jmel.MelBanks(jmel.MelBanksOptions(num_bins=num_bins),
                       _frame_opts(jwindow), vtln_warp_factor=warp)
    tb = tmel.MelBanks(tmel.MelBanksOptions(num_bins=num_bins),
                       _frame_opts(twindow), vtln_warp_factor=warp)
    np.testing.assert_array_equal(tb.matrix, jb.matrix)
    np.testing.assert_array_equal(tb.center_freqs, jb.center_freqs)


@pytest.mark.parametrize("window_type", ["povey", "hamming", "hanning",
                                         "rectangular", "blackman"])
def test_window_function_equal(window_type):
    np.testing.assert_array_equal(
        twindow.feature_window_function(
            _frame_opts(twindow, window_type=window_type)),
        jwindow.feature_window_function(
            _frame_opts(jwindow, window_type=window_type)))


@pytest.mark.parametrize("dither,snip", [(0.0, True), (1.0, True),
                                         (0.0, False), (1.0, False)])
def test_extract_frames_equal(dither, snip):
    wave = np.random.default_rng(7).standard_normal(5123).astype(
        np.float32) * 100
    got = twindow.extract_frames(
        wave, _frame_opts(twindow, dither=dither, snip_edges=snip),
        np.random.default_rng(3))
    want = jwindow.extract_frames(
        wave, _frame_opts(jwindow, dither=dither, snip_edges=snip),
        np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    assert twindow.num_frames(5123, _frame_opts(twindow, snip_edges=snip)) \
        == jwindow.num_frames(5123, _frame_opts(jwindow, snip_edges=snip))


def test_preprocess_then_window_matches_process_window():
    """preprocess_frames + the kernel's window multiply (+ the implicit
    zero padding) is the original's process_window."""
    fo_t = _frame_opts(twindow, dither=0.0)
    fo_j = _frame_opts(jwindow, dither=0.0)
    frames = (np.random.default_rng(5).standard_normal(
        (30, fo_t.window_size)) * 50).astype(np.float32)
    win = twindow.feature_window_function(fo_t)
    x, ge = twindow.preprocess_frames(torch.from_numpy(frames), fo_t)
    got = torch.nn.functional.pad(x * torch.from_numpy(win)[None, :],
                                  (0, fo_t.padded_window_size - 400))
    want, we = jwindow.process_window(jnp.asarray(frames), jnp.asarray(win),
                                      fo_j)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), atol=1e-5)


def test_dft_matrices_equal():
    c1, s1 = dft_matrices(512, 257)
    c2, s2 = _dft_matrices(512, 257)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)


@pytest.mark.parametrize("num_bins", [23, 40])
def test_fbank_reference_matches_xla_and_pallas(num_bins):
    fo = jwindow.FrameExtractionOptions(dither=0.0)
    mo = jmel.MelBanksOptions(num_bins=num_bins)
    frames = (np.random.default_rng(1234).standard_normal(
        (50, fo.window_size)) * 10).astype(np.float32)
    window = jwindow.feature_window_function(fo)
    cosm, sinm = _dft_matrices(fo.padded_window_size,
                               fo.padded_window_size // 2 + 1)
    cosm, sinm = cosm[:fo.window_size], sinm[:fo.window_size]
    melm = jmel.MelBanks(mo, fo).matrix.T
    xla = np.asarray(fbank_xla(jnp.asarray(frames), jnp.asarray(window),
                               jnp.asarray(cosm), jnp.asarray(sinm),
                               jnp.asarray(melm)))
    pallas = np.asarray(PallasFbank(fo, mo, tile_t=128)(
        jnp.asarray(frames), interpret=True))
    got = fbank_reference(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (frames, window, cosm, sinm, melm)))
    np.testing.assert_allclose(got.numpy(), xla, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-3, rtol=0)
    # the wrapper on a CPU tensor is the plain version on its own tables
    k = CudaFbank(twindow.FrameExtractionOptions(dither=0.0),
                  tmel.MelBanksOptions(num_bins=num_bins), device="cpu")
    np.testing.assert_array_equal(k(torch.from_numpy(frames)).numpy(),
                                  got.numpy())
    assert k.launches == 0


def test_fbank_wrapper_rejects_bad_input():
    k = CudaFbank(twindow.FrameExtractionOptions(),
                  tmel.MelBanksOptions(num_bins=40), device="cpu")
    with pytest.raises(ValueError):
        k(torch.zeros((4, 399)))
    with pytest.raises(TypeError):
        k(torch.zeros((4, 400), dtype=torch.float64))


def _speechlike(rng, seconds):
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    x = 200.0 * rng.standard_normal(n)
    x += 3000.0 * np.sin(2 * np.pi * 140.0 * t) * (1 + np.sin(3 * t))
    return x.astype(np.float32)


@pytest.mark.parametrize("use_energy", [False, True])
def test_fbank_compute_matches_jax(use_energy):
    rng = np.random.default_rng(11)
    wave = _speechlike(rng, 1.3)
    jf = jcompute.Fbank(jcompute.FbankOptions(
        mel_opts=jmel.MelBanksOptions(num_bins=40), use_energy=use_energy))
    tf = tcompute.Fbank(tcompute.FbankOptions(
        mel_opts=tmel.MelBanksOptions(num_bins=40), use_energy=use_energy),
        device="cpu")
    want = jf.compute(wave, np.random.default_rng(2))
    got = tf.compute(wave, np.random.default_rng(2)).numpy()
    assert got.shape == want.shape == (128, 40 + use_energy)
    # non-silent frames: DFT by products vs an FFT differ at ~1e-4 in
    # log-mel; near-silent bins would amplify the difference
    loud = want[:, -40:].min(axis=1) > 1.0
    assert loud.sum() > 100
    np.testing.assert_allclose(got[loud], want[loud], atol=2e-3, rtol=0)


SPECTRA = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("use_power,use_log", SPECTRA)
def test_fbank_reference_flags_match_xla_arithmetic(use_power, use_log):
    """fbank_reference's two flags against the reference Fbank's own XLA
    arithmetic (kaldi_tpu/features/compute.py: sqrt of the power, the
    floor, the log), on the same products as ``fbank_xla``.  Log domain
    atol 1e-4 as above; linear domain rtol 1e-4 on the floored energies
    (float32 summation order)."""
    fo = jwindow.FrameExtractionOptions(dither=0.0)
    mo = jmel.MelBanksOptions(num_bins=40)
    frames = (np.random.default_rng(99).standard_normal(
        (50, fo.window_size)) * 10).astype(np.float32)
    window = jwindow.feature_window_function(fo)
    cosm, sinm = _dft_matrices(fo.padded_window_size,
                               fo.padded_window_size // 2 + 1)
    cosm, sinm = cosm[:fo.window_size], sinm[:fo.window_size]
    melm = jmel.MelBanks(mo, fo).matrix.T
    fw = jnp.asarray(frames) * jnp.asarray(window)[None, :]
    re, im = fw @ jnp.asarray(cosm), fw @ jnp.asarray(sinm)
    power = re * re + im * im
    if not use_power:
        power = jnp.sqrt(power)
    mel_e = jnp.maximum(power @ jnp.asarray(melm), tfbank._EPS)
    want = np.asarray(jnp.log(mel_e) if use_log else mel_e)
    got = fbank_reference(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (frames, window, cosm, sinm, melm)),
                          use_power=use_power, use_log=use_log).numpy()
    if use_log:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert (got >= tfbank._EPS).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # the wrapper on a CPU tensor is the plain version with its flags
    k = CudaFbank(twindow.FrameExtractionOptions(dither=0.0),
                  tmel.MelBanksOptions(num_bins=40), device="cpu",
                  use_power=use_power, use_log=use_log)
    np.testing.assert_array_equal(k(torch.from_numpy(frames)).numpy(), got)
    assert k.launches == 0


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("use_power,use_log", SPECTRA)
def test_fbank_spectrum_options_match_jax(use_power, use_log, use_energy):
    """The port's Fbank at each use_power x use_log_fbank setting equals
    the JAX Fbank on loud frames: atol 2e-3 in the log domain (DFT by
    products vs an FFT, as above), rtol 1e-4 in the linear domain; the
    energy column is the raw log-energy on both sides (1e-4)."""
    wave = _speechlike(np.random.default_rng(13), 1.3)
    kw = dict(use_energy=use_energy, use_power=use_power,
              use_log_fbank=use_log)
    jf = jcompute.Fbank(jcompute.FbankOptions(
        mel_opts=jmel.MelBanksOptions(num_bins=40), **kw))
    tf = tcompute.Fbank(tcompute.FbankOptions(
        mel_opts=tmel.MelBanksOptions(num_bins=40), **kw), device="cpu")
    want = jf.compute(wave, np.random.default_rng(2))
    got = tf.compute(wave, np.random.default_rng(2)).numpy()
    assert got.shape == want.shape == (128, 40 + use_energy) == (128, tf.dim)
    mel_w = want[:, -40:] if use_log else np.log(want[:, -40:])
    loud = mel_w.min(axis=1) > 1.0
    assert loud.sum() > 100
    if use_log:
        np.testing.assert_allclose(got[loud], want[loud], atol=2e-3, rtol=0)
    else:
        np.testing.assert_allclose(got[loud, -40:], want[loud, -40:],
                                   rtol=1e-4, atol=0)
    if use_energy:
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4, rtol=0)
    assert tf.kernel.launches == 0


@pytest.mark.parametrize("chunk", [160, 1000])
def test_streamed_linear_fbank_equals_offline(chunk):
    """Fbank(use_log_fbank=False) streamed through OnlineFeaturePipeline
    in chunks equals the offline computer on the whole waveform: the
    same arithmetic on fewer frames a call, whose products block the
    sums another way (rtol 1e-4, as the linear-domain bar above)."""
    from kaldi_tpu_torch.features import online as tonline
    wave = _speechlike(np.random.default_rng(14), 0.6)
    fb = tcompute.Fbank(tcompute.FbankOptions(
        frame_opts=twindow.FrameExtractionOptions(dither=0.0),
        mel_opts=tmel.MelBanksOptions(num_bins=40), use_log_fbank=False),
        device="cpu")
    pipe = tonline.OnlineFeaturePipeline(fb)
    for i in range(0, len(wave), chunk):
        pipe.accept_waveform(wave[i:i + chunk])
    pipe.input_finished()
    got = pipe.get_frames(0, pipe.num_frames_ready()).numpy()
    want = fb.compute(wave).numpy()
    assert got.shape == want.shape == (58, 40)
    assert (want > 1.0).mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_fbank_energy_floor_matches_jax():
    rng = np.random.default_rng(12)
    wave = _speechlike(rng, 1.3)
    floor = math.exp(20.0)
    jf = jcompute.Fbank(jcompute.FbankOptions(
        mel_opts=jmel.MelBanksOptions(num_bins=40), use_energy=True,
        energy_floor=floor))
    tf = tcompute.Fbank(tcompute.FbankOptions(
        mel_opts=tmel.MelBanksOptions(num_bins=40), use_energy=True,
        energy_floor=floor), device="cpu")
    want = jf.compute(wave, np.random.default_rng(3))
    got = tf.compute(wave, np.random.default_rng(3)).numpy()
    floored = got[:, 0] == np.float32(20.0)
    assert 0 < floored.sum() < len(got)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4, rtol=0)
    loud = want[:, 1:].min(axis=1) > 1.0
    np.testing.assert_allclose(got[loud], want[loud], atol=2e-3, rtol=0)


@pytest.mark.gpu
def test_fbank_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    k = CudaFbank(twindow.FrameExtractionOptions(),
                  tmel.MelBanksOptions(num_bins=40), device=dev)
    frames = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (1000, 400)) * 1000).astype(np.float32)).to(dev)
    got = k(frames)
    want = fbank_reference(frames, k.window, k.cos, k.sin, k.mel)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert float((got - want).abs().max()) <= 2e-3


# -- the kernel's layout and arithmetic, on the CPU --------------------

# the three configurations the paths run: the TDNN-F's 40 bins, the MFCC
# of mini_librispeech (16 kHz, 23 bins) and of the yes/no recipe (8 kHz,
# 15 bins)
CONFIGS = [(16000.0, 40), (16000.0, 23), (8000.0, 15)]


def _kernel_of(samp_freq, num_bins):
    return CudaFbank(twindow.FrameExtractionOptions(samp_freq=samp_freq,
                                                    dither=0.0),
                     tmel.MelBanksOptions(num_bins=num_bins), device="cpu")


def tf32(a):
    """float32 → TF32 in numpy: round to nearest, ties away from zero
    (``cvt.rna``), by adding half of the dropped 13 bits and masking."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def product_3xtf32(a, b):
    """a·b as the kernels take it: hi·hi + (hi·lo + lo·hi), float32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (ah @ bl + al @ bh)


def product_tf32(a, b):
    return tf32(a) @ tf32(b)


def test_round_tf32_is_cvt_rna():
    """The port's torch rounding equals the numpy bit mask; ties go away
    from zero, and the result keeps 10 stored mantissa bits."""
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    x = np.concatenate([x * 1e3, x * 1e-3, np.float32([0.0, -0.0, 1.0])])
    got = round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), tf32(x).view(np.uint32))
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    tie = np.float32(1.0 + 2.0 ** -11)      # exactly half a TF32 ulp up
    np.testing.assert_array_equal(tf32(np.float32([tie, -tie])),
                                  np.float32([1.0 + 2.0 ** -10,
                                              -1.0 - 2.0 ** -10]))
    assert np.abs(x - got).max() <= 2.0 ** -11 * np.abs(x).max()


def _path_frames(samp_freq, k, rng):
    """Pre-processed frames of the paths' waveforms: harmonic voiced
    segments over noise (the wav path's) at 16 kHz, speech rendered
    from a pdf alignment (the GMM path's) at both rates."""
    from kaldi_tpu_torch.tools.synth import pdf_signatures, synth_speech
    fo = twindow.FrameExtractionOptions(samp_freq=samp_freq, dither=0.0)
    waves = []
    if samp_freq == 16000.0:
        waves.append(_speechlike(rng, 1.3))
    freqs, amps = pdf_signatures(rng, 10, silent=[0])
    shift = int(samp_freq / 100)
    waves.append(synth_speech(np.repeat(rng.integers(0, 10, 20), 6), freqs,
                              amps, rng, samp_freq=samp_freq,
                              window=k.win_size, shift=shift))
    frames = [twindow.extract_frames(w, fo) for w in waves]
    return twindow.preprocess_frames(
        torch.from_numpy(np.concatenate(frames)), fo)[0]


@pytest.mark.parametrize("samp_freq,num_bins", CONFIGS)
def test_fbank_3xtf32_holds_where_tf32_does_not(samp_freq, num_bins):
    k = _kernel_of(samp_freq, num_bins)
    x = _path_frames(samp_freq, k, np.random.default_rng(num_bins))
    want = k.reference(x).numpy()
    xw = (x * k.window).numpy()
    tables = np.stack([k.cos.numpy(), k.sin.numpy()], -1).reshape(
        k.win_size, 2 * k.n_bins)           # interleaved: cos_k, sin_k
    err = {}
    for name, product in (("3xtf32", product_3xtf32), ("tf32", product_tf32)):
        y = product(xw, tables)
        power = y[:, 0::2] ** 2 + y[:, 1::2] ** 2
        got = np.log(np.maximum(power @ k.mel.numpy(), tfbank._EPS))
        err[name] = float(np.abs(got - want).max())
    assert err["3xtf32"] <= 2e-3, err
    assert err["tf32"] > 2e-3, err


@pytest.mark.parametrize("samp_freq,num_bins", CONFIGS)
def test_mel_groups_cover_the_filters(samp_freq, num_bins):
    """Groups are runs of filters in order; each filter's nonzero bins
    lie inside its group's n-tiles; groups stay within the kernel's
    limits (16 n-tiles, 128 mel weights) and balance bins."""
    k = _kernel_of(samp_freq, num_bins)
    mel = k.mel.numpy()
    nz = mel != 0
    assert (k.groups[1:, 2] == k.groups[:-1, 3]).all()
    assert k.groups[0, 2] == 0 and k.groups[-1, 3] == k.n_mel
    assert len(k.groups) == {257: 8, 129: 4}[k.n_bins]
    spans = []
    for k0, nt, m0, m1, _ in k.groups:
        assert 1 <= nt <= tfbank.MAX_GROUP_TILES
        for m in range(m0, m1):
            lo, hi = k.franges[m]
            assert k0 <= lo and hi <= k0 + 4 * nt
            assert not nz[:lo, m].any() and not nz[hi:, m].any()
            assert nz[lo:hi, m].all()
        assert (k.franges[m0:m1, 1] - k.franges[m0:m1, 0]).sum() <= \
            tfbank.MAX_GROUP_WEIGHTS
        spans.append(4 * nt)
    assert max(spans) <= 2 * min(spans) + 8
    melw, woff = tfbank.filter_weights(mel, k.franges)
    for m, (lo, hi) in enumerate(k.franges):
        np.testing.assert_array_equal(melw[woff[m]:woff[m] + hi - lo],
                                      mel[lo:hi, m])


@pytest.mark.parametrize("samp_freq,num_bins", CONFIGS)
def test_fbank_by_groups_from_split_tables_is_the_reference(samp_freq,
                                                            num_bins):
    """Per group, the tables in fragment order recompose to the
    interleaved cos/sin columns of its bins, split exactly as
    round_tf32 splits; the fbank computed group by group from them in
    plain torch equals fbank_reference."""
    k = _kernel_of(samp_freq, num_bins)
    x = _path_frames(samp_freq, k, np.random.default_rng(7))
    want = k.reference(x)
    ks = k.kp // 8
    fw = torch.zeros((x.shape[0], k.kp))
    fw[:, :k.win_size] = x * k.window
    got = torch.empty_like(want)
    for k0, nt, m0, m1, off in k.groups:
        hi, lo = from_fragment_order(
            k.tables[off:off + ks * nt * 128].reshape(ks, nt, 32, 4))
        b = torch.zeros((k.kp, 4 * nt, 2))
        n = min(4 * nt, k.n_bins - k0)
        b[:k.win_size, :n, 0] = k.cos[:, k0:k0 + n]
        b[:k.win_size, :n, 1] = k.sin[:, k0:k0 + n]
        b = b.reshape(k.kp, 8 * nt)
        assert torch.equal(hi, round_tf32(b))
        assert torch.equal(lo, round_tf32(b - hi))
        y = fw @ (hi + lo)
        power = y[:, 0::2] ** 2 + y[:, 1::2] ** 2
        for m in range(m0, m1):
            lo_, hi_ = k.franges[m]
            e = power[:, lo_ - k0:hi_ - k0] @ k.mel[lo_:hi_, m]
            got[:, m] = torch.log(torch.clamp_min(e, tfbank._EPS))
    # hi + lo carries the tables to 2^-22; summation order alone moves
    # log-mel by ~1e-4 on the lowest filter, just above the DC-removed
    # floor (the bound of fbank_reference against fbank_xla above); a
    # wrong bin or filter index would be off by O(1)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


# -- MFCC, CMVN, deltas, splicing and transforms (the GMM feature path) --

def test_dct_and_lifter_equal_jax():
    np.testing.assert_array_equal(tcompute.compute_dct_matrix(13, 23),
                                  jcompute.compute_dct_matrix(13, 23))
    np.testing.assert_array_equal(tcompute.compute_lifter_coeffs(22.0, 13),
                                  jcompute.compute_lifter_coeffs(22.0, 13))


@pytest.mark.parametrize("lifter", [0.0, 22.0])
@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("samp_freq,num_bins,num_ceps",
                         [(8000.0, 15, 10), (16000.0, 23, 13)])
def test_mfcc_compute_matches_jax(samp_freq, num_bins, num_ceps,
                                  use_energy, lifter):
    """Tolerance: log-mel is held at 2e-3 (DFT by products vs an FFT);
    the orthonormal DCT keeps that error's RMS, and the lifter scales
    cepstrum k by its coefficient (up to 1 + Q/2 = 12 at Q = 22), so
    column k is held at 2e-3 · lifter_k.  The energy column is the raw
    log-energy, computed the same way on both sides (1e-4)."""
    n = int(1.3 * samp_freq)
    t = np.arange(n) / samp_freq
    wave = (200.0 * np.random.default_rng(11).standard_normal(n)
            + 3000.0 * np.sin(2 * np.pi * 140.0 * t) * (1 + np.sin(3 * t))
            ).astype(np.float32)
    kw = dict(num_ceps=num_ceps, use_energy=use_energy,
              cepstral_lifter=lifter)
    jm = jcompute.Mfcc(jcompute.MfccOptions(
        frame_opts=jwindow.FrameExtractionOptions(samp_freq=samp_freq),
        mel_opts=jmel.MelBanksOptions(num_bins=num_bins), **kw))
    tm = tcompute.Mfcc(tcompute.MfccOptions(
        frame_opts=twindow.FrameExtractionOptions(samp_freq=samp_freq),
        mel_opts=tmel.MelBanksOptions(num_bins=num_bins), **kw),
        device="cpu")
    want = jm.compute(wave, np.random.default_rng(2))
    got = tm.compute(wave, np.random.default_rng(2)).numpy()
    assert got.shape == want.shape == (128, num_ceps) == (128, tm.dim)
    scale = (tcompute.compute_lifter_coeffs(lifter, num_ceps) if lifter
             else np.ones(num_ceps, np.float32))
    tol = np.broadcast_to(2e-3 * scale, got.shape).copy()
    if use_energy:
        tol[:, 0] = 1e-4
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max(0)
    assert tm.kernel.launches == 0


@pytest.mark.parametrize("norm_vars", [False, True])
def test_cmvn_matches_jax(norm_vars):
    from kaldi_tpu.features import cmvn as jcmvn
    from kaldi_tpu_torch.features import cmvn as tcmvn
    rng = np.random.default_rng(4)
    utts = [(rng.standard_normal((n, 13)) * 3 + 5).astype(np.float32)
            for n in (50, 71, 33)]
    want_stats = [jcmvn.compute_cmvn_stats(u) for u in utts]
    got_stats = [tcmvn.compute_cmvn_stats(torch.from_numpy(u))
                 for u in utts]
    for g, w in zip(got_stats, want_stats):
        assert g.dtype == torch.float64 and g.shape == (2, 14)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)
    spk_w = jcmvn.sum_cmvn_stats(want_stats)
    spk_g = tcmvn.sum_cmvn_stats(got_stats)
    np.testing.assert_allclose(spk_g.numpy(), spk_w, rtol=1e-12)
    for u in utts:
        want = jcmvn.apply_cmvn(u, spk_w, norm_vars=norm_vars)
        got = tcmvn.apply_cmvn(torch.from_numpy(u), spk_g,
                               norm_vars=norm_vars)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("order,window,T", [(2, 2, 40), (1, 3, 17),
                                            (2, 2, 3), (2, 2, 1)])
def test_add_deltas_matches_jax(order, window, T):
    from kaldi_tpu.features import functions as jfun
    from kaldi_tpu_torch.features import functions as tfun
    x = np.random.default_rng(T).standard_normal((T, 13)).astype(
        np.float32)
    for a, b in zip(tfun.delta_scales(tfun.DeltaFeaturesOptions(order,
                                                                window)),
                    jfun.delta_scales(jfun.DeltaFeaturesOptions(order,
                                                                window))):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jfun.add_deltas(
        jnp.asarray(x), jfun.DeltaFeaturesOptions(order, window)))
    got = tfun.add_deltas(torch.from_numpy(x),
                          tfun.DeltaFeaturesOptions(order, window))
    assert got.shape == want.shape == (T, 13 * (order + 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("left,right,T", [(3, 3, 30), (4, 2, 5), (0, 1, 1)])
def test_splice_frames_matches_jax(left, right, T):
    from kaldi_tpu.features import functions as jfun
    from kaldi_tpu_torch.features import functions as tfun
    x = np.random.default_rng(T).standard_normal((T, 13)).astype(
        np.float32)
    want = np.asarray(jfun.splice_frames(jnp.asarray(x), left, right))
    got = tfun.splice_frames(torch.from_numpy(x), left, right)
    assert got.shape == want.shape == (T, 13 * (left + right + 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("affine", [False, True])
def test_apply_transform_matches_jax(affine):
    from kaldi_tpu.am import transforms as jtr
    from kaldi_tpu_torch.am import transforms as ttr
    rng = np.random.default_rng(8)
    x = rng.standard_normal((60, 91)).astype(np.float32)
    mat = (rng.standard_normal((40, 92 if affine else 91)) / 10).astype(
        np.float32)
    want = jtr.apply_transform(x, mat)
    got = ttr.apply_transform(torch.from_numpy(x), mat)
    assert got.dtype == torch.float32 and got.shape == (60, 40)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(Exception, match="transform shape"):
        ttr.apply_transform(torch.from_numpy(x), mat[:, :50])
