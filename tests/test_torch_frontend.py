"""The rest of the feature frontend in the PyTorch port against the JAX
package: Spectrogram, Plp, the fbank kernel with identity filters, the
batched frontend and its GMM provider, sliding-window CMN, resampling
and pitch.

The same seeded numpy inputs go through kaldi_tpu and kaldi_tpu_torch
(the port on the CPU, ``device="cpu"``, where the fbank kernel's wrapper
runs its plain version).  Tolerances:

* Spectrogram: the port's DFT is by products, the original's an FFT;
  both err by about float32 rounding of the frame's norm, absolutely,
  so a lone bin's log power is only as good as its share of the frame.
  On bins whose power is at least 1e-5 of the frame's largest bin, the
  log power is held at 2e-3 (the log-mel bar); on every bin, the power
  at 1e-5 of the frame's largest bin (measured here: 1.5e-4 and 2.1e-6).
  Column 0 is the raw log-energy on both sides: 1e-4.
* Plp: atol 1e-4 + rtol 1e-4 on every frame of speech-like audio and of
  white noise, all of it non-silent (measured: 2e-5).  ``_durbin`` alone
  on the same autocorrelations: the LPC within 1e-5 and the residual
  within rtol 1e-5 (float32 rounding through the recursion; measured
  1.8e-6 and 8e-7); ``_lpc_to_cepstrum`` alone on the same LPC: 1e-6.
* The identity-filter kernel's layout: every DFT bin (DC and Nyquist
  included) is its own filter inside its group's tiles, and the group by
  group model of the kernel equals ``fbank_reference`` within 1e-3 in
  log power (summation order; a wrong bin would be off by O(1)).
* BatchedFrontend: log-mel within 2e-3 (DFT by products against an
  FFT), so cepstrum k within 2e-3 · lifter_k, the energy column within
  1e-4; CMN and the deltas are sums of at most 2 and 1.2 times those
  errors, so 4e-3 · lifter_k covers every column.  Against the port's
  own per-utterance ``Mfcc`` (+ ``add_deltas``): 1e-4 (the same kernel
  version, other shapes of the same products).
* GmmDecodableProvider: log-likelihoods within 1e-3 + 1e-3 · |value|
  of the JAX provider's (the features' 2e-3 through a diagonal GMM of
  unit-scale variances), and equal to the port's own
  ``AmDiagGmm.loglikes`` of the batched features within 1e-4.
* ``sliding_window_cmn``, ``linear_resample``, ``compute_kaldi_pitch``
  and ``process_pitch`` are numpy copies: equal bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import gmm as jgmm
from kaldi_tpu.features import batch as jbatch
from kaldi_tpu.features import compute as jcompute
from kaldi_tpu.features import functions as jfunctions
from kaldi_tpu.features import mel as jmel
from kaldi_tpu.features import pitch as jpitch
from kaldi_tpu.features import resample as jresample
from kaldi_tpu.features import window as jwindow
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.features import batch as tbatch
from kaldi_tpu_torch.features import compute as tcompute
from kaldi_tpu_torch.features import functions as tfunctions
from kaldi_tpu_torch.features import mel as tmel
from kaldi_tpu_torch.features import pitch as tpitch
from kaldi_tpu_torch.features import resample as tresample
from kaldi_tpu_torch.features import window as twindow
from kaldi_tpu_torch.ops import fbank as tfbank
from kaldi_tpu_torch.ops.fbank import CudaFbank, fbank_reference
from kaldi_tpu_torch.ops.tf32 import from_fragment_order, round_tf32

torch.set_num_threads(1)


def speechlike(rng, seconds, samp_freq=16000.0):
    """Noise under a slowly modulated 140 Hz tone (the audio of
    tests/test_torch_features.py)."""
    n = int(seconds * samp_freq)
    t = np.arange(n) / samp_freq
    x = 200.0 * rng.standard_normal(n)
    x += 3000.0 * np.sin(2 * np.pi * 140.0 * t) * (1 + np.sin(3 * t))
    return x.astype(np.float32)


def white(rng, seconds, samp_freq=16000.0):
    return (100.0 * rng.standard_normal(int(seconds * samp_freq))).astype(
        np.float32)


AUDIO = {"speech": speechlike, "noise": white}


# -- Spectrogram --------------------------------------------------------

def _spectrogram_pair(samp_freq, energy_floor):
    kw = dict(energy_floor=energy_floor)
    js = jcompute.Spectrogram(jcompute.SpectrogramOptions(
        frame_opts=jwindow.FrameExtractionOptions(samp_freq=samp_freq), **kw))
    ts = tcompute.Spectrogram(tcompute.SpectrogramOptions(
        frame_opts=twindow.FrameExtractionOptions(samp_freq=samp_freq),
        **kw), device="cpu")
    return js, ts


def assert_spectra_close(got, want):
    """Columns 1.. are log power: 2e-3 where the power is at least 1e-5
    of the frame's largest bin, and the power within 1e-5 of that bin
    everywhere.  Column 0 is the log-energy: 1e-4."""
    pw, pg = np.exp(want[:, 1:].astype(np.float64)), \
        np.exp(got[:, 1:].astype(np.float64))
    top = pw.max(axis=1, keepdims=True)
    big = pw >= 1e-5 * top
    assert big.mean() > 0.9
    assert np.abs(got[:, 1:] - want[:, 1:])[big].max() <= 2e-3
    assert (np.abs(pg - pw) / top).max() <= 1e-5
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("energy_floor", [0.0, math.exp(20.0)],
                         ids=["no-floor", "floor"])
@pytest.mark.parametrize("samp_freq", [16000.0, 8000.0])
def test_spectrogram_matches_jax(samp_freq, energy_floor):
    wave = speechlike(np.random.default_rng(11), 1.3, samp_freq)
    js, ts = _spectrogram_pair(samp_freq, energy_floor)
    want = js.compute(wave, np.random.default_rng(2))
    got = ts.compute(wave, np.random.default_rng(2)).numpy()
    n_bins = {16000.0: 257, 8000.0: 129}[samp_freq]
    assert got.shape == want.shape == (128, n_bins) == (128, ts.dim)
    assert_spectra_close(got, want)
    if energy_floor:
        floored = got[:, 0] == np.float32(20.0)
        assert 0 < floored.sum() < len(got)
    assert ts.kernel.launches == 0


def test_spectrogram_finite_and_shaped():
    """tests/test_features.py::test_spectrogram on the port."""
    wave = (np.random.default_rng(0).standard_normal(4000) * 10).astype(
        np.float32)
    sp = tcompute.Spectrogram(device="cpu")
    sp.opts.frame_opts.dither = 0.0
    out = sp.compute(wave).numpy()
    assert out.shape == (23, 257)
    assert np.all(np.isfinite(out))


# -- PLP ----------------------------------------------------------------

PLP_OPTIONS = [{}, {"cepstral_lifter": 0.0}, {"cepstral_scale": 1.5},
               {"use_energy": False}]


@pytest.mark.parametrize("audio", sorted(AUDIO))
@pytest.mark.parametrize("kw", PLP_OPTIONS,
                         ids=["defaults", "no-lifter", "scale", "no-energy"])
def test_plp_matches_jax(kw, audio):
    wave = AUDIO[audio](np.random.default_rng(11), 1.3)
    jp = jcompute.Plp(jcompute.PlpOptions(**kw))
    tp = tcompute.Plp(tcompute.PlpOptions(**kw), device="cpu")
    want = jp.compute(wave, np.random.default_rng(2))
    got = tp.compute(wave, np.random.default_rng(2)).numpy()
    assert got.shape == want.shape == (128, 13) == (128, tp.dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert tp.kernel.launches == 0


def test_plp_finite_and_shaped():
    """tests/test_features.py::test_plp_finite_and_shaped on the port."""
    wave = (np.random.default_rng(0).standard_normal(8000) * 100).astype(
        np.float32)
    plp = tcompute.Plp(tcompute.PlpOptions(
        frame_opts=twindow.FrameExtractionOptions(dither=0.0)), device="cpu")
    out = plp.compute(wave).numpy()
    assert out.shape == (48, 13)
    assert np.all(np.isfinite(out))
    quiet = plp.compute(wave * 0.01).numpy()
    assert quiet[:, 0].mean() < out[:, 0].mean()


def test_plp_tables_equal_jax():
    jp = jcompute.Plp()
    tp = tcompute.Plp(device="cpu")
    np.testing.assert_array_equal(tp.equal_loudness.numpy(),
                                  jp._equal_loudness)
    np.testing.assert_array_equal(tp.idft.numpy(), jp._idft)
    np.testing.assert_array_equal(tcompute._idft_bases(13, 25),
                                  jcompute._idft_bases(13, 25))


def _autocorrelations(audio):
    """The PLP pipeline's autocorrelations of ``audio``, taken on the
    JAX side up to the IDFT product."""
    wave = AUDIO[audio](np.random.default_rng(11), 1.3)
    p = jcompute.Plp()
    power, _ = p._power_spectrum(jnp.asarray(
        p.frames(wave, np.random.default_rng(2))))
    mel_e = jnp.maximum(power @ p._mel, jcompute._EPS)
    mel_e = (mel_e * p._equal_loudness[None, :]) ** p.opts.compress_factor
    dup = jnp.concatenate([mel_e[:, :1], mel_e, mel_e[:, -1:]], axis=1)
    return np.array(dup @ p._idft)


@pytest.mark.parametrize("audio", sorted(AUDIO))
def test_durbin_and_cepstrum_match_jax(audio):
    ac = _autocorrelations(audio)
    jl, je = (np.asarray(a) for a in jcompute._durbin(jnp.asarray(ac), 12))
    tl, te = tcompute._durbin(torch.from_numpy(ac.copy()), 12)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-5, atol=0)
    assert np.abs(jl).max() > 0.5            # not a trivial recursion
    jc_ = np.asarray(jcompute._lpc_to_cepstrum(jnp.asarray(jl), 12, 13))
    tc_ = tcompute._lpc_to_cepstrum(torch.from_numpy(jl.copy()), 12, 13)
    np.testing.assert_allclose(tc_.numpy(), jc_, atol=1e-6, rtol=0)


@pytest.mark.parametrize("order,num_ceps", [(4, 13), (12, 8)])
def test_cepstrum_orders_match_jax(order, num_ceps):
    """The recursion past the LPC order (a_i = 0 there) and with fewer
    cepstra than coefficients."""
    lpc = (0.3 * np.random.default_rng(order).standard_normal(
        (50, order))).astype(np.float32)
    want = np.asarray(jcompute._lpc_to_cepstrum(jnp.asarray(lpc), order,
                                                num_ceps))
    got = tcompute._lpc_to_cepstrum(torch.from_numpy(lpc), order, num_ceps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -- the fbank kernel with identity filters ------------------------------

RATES = [16000.0, 8000.0]


def _identity_kernel(samp_freq):
    fo = twindow.FrameExtractionOptions(samp_freq=samp_freq, dither=0.0)
    n_bins = fo.padded_window_size // 2 + 1
    return CudaFbank(fo, device="cpu",
                     filters=np.eye(n_bins, dtype=np.float32))


@pytest.mark.parametrize("samp_freq", RATES)
def test_identity_filters_layout_covers_every_bin(samp_freq):
    """One filter per bin, each inside its group's n-tiles, DC and
    Nyquist included; groups within the kernel's limits."""
    k = _identity_kernel(samp_freq)
    assert k.n_mel == k.n_bins == {16000.0: 257, 8000.0: 129}[samp_freq]
    np.testing.assert_array_equal(k.franges[:, 0], np.arange(k.n_bins))
    np.testing.assert_array_equal(k.franges[:, 1], np.arange(k.n_bins) + 1)
    assert k.groups[0, 2] == 0 and k.groups[-1, 3] == k.n_bins
    assert (k.groups[1:, 2] == k.groups[:-1, 3]).all()
    for k0, nt, m0, m1, _ in k.groups:
        assert 1 <= nt <= tfbank.MAX_GROUP_TILES
        assert m1 - m0 <= tfbank.MAX_GROUP_WEIGHTS
        assert k0 <= k.franges[m0, 0] and k.franges[m1 - 1, 1] <= k0 + 4 * nt
    np.testing.assert_array_equal(k.melw.numpy(), np.ones(k.n_bins))


@pytest.mark.parametrize("samp_freq", RATES)
def test_identity_filters_by_groups_is_the_reference(samp_freq):
    """The kernel's arithmetic group by group from its split tables, in
    plain torch, equals fbank_reference: the log power spectrum."""
    k = _identity_kernel(samp_freq)
    wave = speechlike(np.random.default_rng(5), 0.5, samp_freq)
    fo = twindow.FrameExtractionOptions(samp_freq=samp_freq, dither=0.0)
    x = twindow.preprocess_frames(torch.from_numpy(
        twindow.extract_frames(wave, fo)), fo)[0]
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
        y = fw @ (hi + lo)
        power = y[:, 0::2] ** 2 + y[:, 1::2] ** 2
        for m in range(m0, m1):
            lo_, hi_ = k.franges[m]
            e = power[:, lo_ - k0:hi_ - k0] @ k.mel[lo_:hi_, m]
            got[:, m] = torch.log(torch.clamp_min(e, tfbank._EPS))
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    # the plain version is the floored log of |rfft|^2
    spec = torch.fft.rfft(torch.nn.functional.pad(
        x * k.window, (0, fo.padded_window_size - k.win_size)))
    ref = torch.log(torch.clamp_min(spec.real ** 2 + spec.imag ** 2,
                                    tfbank._EPS))
    assert_spectra_close(want.numpy(), ref.numpy())


def test_filters_argument_checks_and_default():
    fo = twindow.FrameExtractionOptions()
    mo = tmel.MelBanksOptions(num_bins=40)
    mel = tmel.MelBanks(mo, fo).matrix.T
    a, b = CudaFbank(fo, mo, "cpu"), CudaFbank(fo, mo, "cpu", filters=mel)
    np.testing.assert_array_equal(a.mel.numpy(), b.mel.numpy())
    np.testing.assert_array_equal(a.groups, b.groups)
    with pytest.raises(ValueError):
        CudaFbank(fo, device="cpu", filters=np.eye(256, dtype=np.float32))
    with pytest.raises(ValueError):
        CudaFbank(fo, device="cpu", filters=-np.eye(257, dtype=np.float32))


# -- the batched frontend and its GMM provider ---------------------------

@pytest.fixture(scope="module")
def batch_waves():
    rng = np.random.default_rng(3)
    return np.stack([speechlike(rng, 0.5) for _ in range(3)])


def _counting(kernel):
    """Count the calls of a CudaFbank object (the CPU runs its plain
    version, whose ``launches`` stay 0)."""
    calls = []
    inner = kernel.__call__

    class Spy(type(kernel)):
        def __call__(self, frames):
            calls.append(frames.shape[0])
            return inner(frames)

    kernel.__class__ = Spy
    return calls


def _frontends(feature_type, cmn, deltas, **frame):
    jo = jcompute.MfccOptions(frame_opts=jwindow.FrameExtractionOptions(
        dither=0.0, **frame))
    to = tcompute.MfccOptions(frame_opts=twindow.FrameExtractionOptions(
        dither=0.0, **frame))
    return (jbatch.BatchedFrontend(
                jo, feature_type,
                jfunctions.DeltaFeaturesOptions() if deltas else None, cmn),
            tbatch.BatchedFrontend(
                to, feature_type,
                tfunctions.DeltaFeaturesOptions() if deltas else None, cmn,
                device="cpu"))


def _batch_tolerance(fe, shape):
    """4e-3 · lifter_k per cepstral column (2e-3 for log-mel), 1e-4 on
    the energy column of MFCC without CMN or deltas."""
    if fe.feature_type == "mfcc":
        base = 4e-3 * tcompute.compute_lifter_coeffs(22.0, 13)
        if fe.opts.use_energy and not fe.cmn and fe.deltas is None:
            base[0] = 1e-4
    else:
        base = np.full(23, 4e-3, np.float32)
    return np.broadcast_to(np.tile(base, shape[-1] // len(base)), shape)


@pytest.mark.parametrize("deltas", [False, True], ids=["plain", "deltas"])
@pytest.mark.parametrize("cmn", [False, True], ids=["no-cmn", "cmn"])
@pytest.mark.parametrize("feature_type", ["mfcc", "fbank"])
def test_batched_frontend_matches_jax(batch_waves, feature_type, cmn,
                                      deltas):
    jfe, tfe = _frontends(feature_type, cmn, deltas)
    calls = _counting(tfe.kernel)
    want = np.asarray(jfe(batch_waves))
    got = tfe(batch_waves).numpy()
    assert got.shape == want.shape == (3, 48, tfe.dim)
    assert (np.abs(got - want) <= _batch_tolerance(tfe, got.shape)).all(), \
        np.abs(got - want).max(axis=(0, 1))
    assert calls == [3 * 48]                 # one kernel call a batch
    assert tfe.kernel.launches == 0


def test_batched_frontend_clamps_like_jax_without_snip_edges(batch_waves):
    """snip_edges=False: T = (L + shift/2) / shift frames, the last ones
    reading past L; the original's gather clamps to the last sample."""
    jfe, tfe = _frontends("mfcc", False, False, snip_edges=False)
    want = np.asarray(jfe(batch_waves))
    got = tfe(batch_waves).numpy()
    assert got.shape == want.shape == (3, 50, 13)
    assert (np.abs(got - want) <= _batch_tolerance(tfe, got.shape)).all()


@pytest.mark.parametrize("deltas", [False, True], ids=["plain", "deltas"])
def test_batched_frontend_equals_per_utterance(batch_waves, deltas):
    """tests/test_batch_frontend.py on the port: each utterance of the
    batch equals the port's own Mfcc (+ add_deltas).  Its 15 mel bins
    and 10 cepstra at 8 kHz (the yes/no recipe's)."""
    opts = tcompute.MfccOptions(
        frame_opts=twindow.FrameExtractionOptions(samp_freq=8000.0,
                                                  dither=0.0),
        mel_opts=tmel.MelBanksOptions(num_bins=15), num_ceps=10)
    fe = tbatch.BatchedFrontend(
        opts, deltas=tfunctions.DeltaFeaturesOptions() if deltas else None,
        device="cpu")
    single = tcompute.Mfcc(opts, device="cpu")
    got = fe(torch.from_numpy(batch_waves))
    for b in range(3):
        ref = single.compute(batch_waves[b])
        if deltas:
            ref = tfunctions.add_deltas(ref)
        torch.testing.assert_close(got[b], ref, atol=1e-4, rtol=0)


WIDE_BANKS = [15, 17]


@pytest.mark.parametrize("num_bins", WIDE_BANKS)
def test_wide_mel_bank_fbank_and_mfcc_match_jax(num_bins):
    """At 16 kHz the top filters of a bank of 17 bins or fewer span more
    DFT bins (67 and up) than one of the kernel's groups holds (64); the
    port's Fbank and Mfcc take such banks all the same and equal the JAX
    ones: log-mel within 2e-3 on loud frames (the bar of
    tests/test_torch_features.py), cepstrum k within 2e-3 · lifter_k."""
    wave = speechlike(np.random.default_rng(11), 1.3)
    jf = jcompute.Fbank(jcompute.FbankOptions(
        mel_opts=jmel.MelBanksOptions(num_bins=num_bins)))
    tf = tcompute.Fbank(tcompute.FbankOptions(
        mel_opts=tmel.MelBanksOptions(num_bins=num_bins)), device="cpu")
    assert tf.kernel.piece_off is not None
    want = jf.compute(wave, np.random.default_rng(2))
    got = tf.compute(wave, np.random.default_rng(2)).numpy()
    assert got.shape == want.shape == (128, num_bins)
    loud = want.min(axis=1) > 1.0
    assert loud.sum() > 100
    np.testing.assert_allclose(got[loud], want[loud], atol=2e-3, rtol=0)
    jm = jcompute.Mfcc(jcompute.MfccOptions(
        mel_opts=jmel.MelBanksOptions(num_bins=num_bins), num_ceps=13,
        use_energy=False))
    tm = tcompute.Mfcc(tcompute.MfccOptions(
        mel_opts=tmel.MelBanksOptions(num_bins=num_bins), num_ceps=13,
        use_energy=False), device="cpu")
    want = jm.compute(wave, np.random.default_rng(2))
    got = tm.compute(wave, np.random.default_rng(2)).numpy()
    tol = 2e-3 * tcompute.compute_lifter_coeffs(22.0, 13)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max(0)


@pytest.mark.parametrize("num_bins", WIDE_BANKS)
def test_wide_mel_bank_layout_covers_each_bin_once(num_bins):
    """The pieces of a wide bank cover every nonzero bin of every filter
    exactly once with the filter's own weight; each piece fits a group;
    the groups keep the kernel's limits; the kernel's arithmetic group by
    group from its split tables, then the pieces summed in bin order,
    floored and logged, equals fbank_reference (summation order alone:
    1e-3, as for the other banks)."""
    k = CudaFbank(twindow.FrameExtractionOptions(),
                  tmel.MelBanksOptions(num_bins=num_bins), device="cpu")
    mel = k.mel.numpy()
    assert (mel != 0).sum(0).max() > tfbank.PIECE_BINS
    off, cols = k.piece_off.numpy(), k.piece_cols.numpy()
    assert off[0] == 0 and off[-1] == k.n_cols > k.n_mel
    assert sorted(cols.tolist()) == list(range(k.n_cols))
    melw = k.melw.numpy()
    woff = np.cumsum([0] + [hi - lo for lo, hi in k.franges[:-1]])
    for m in range(k.n_mel):
        covered = np.zeros(k.n_bins, np.int64)
        weight = np.zeros(k.n_bins, np.float32)
        for c in cols[off[m]:off[m + 1]]:
            lo, hi = k.franges[c]
            assert 0 < hi - lo <= tfbank.PIECE_BINS
            covered[lo:hi] += 1
            weight[lo:hi] = melw[woff[c]:woff[c] + hi - lo]
        np.testing.assert_array_equal(covered, (mel[:, m] != 0).astype(int))
        np.testing.assert_array_equal(weight, mel[:, m])
    assert k.groups[0, 2] == 0 and k.groups[-1, 3] == k.n_cols
    assert (k.groups[1:, 2] == k.groups[:-1, 3]).all()
    for k0, nt, m0, m1, _ in k.groups:
        assert 1 <= nt <= tfbank.MAX_GROUP_TILES
        assert (k.franges[m0:m1, 1] - k.franges[m0:m1, 0]).sum() <= \
            tfbank.MAX_GROUP_WEIGHTS
        for c in range(m0, m1):
            assert k0 <= k.franges[c, 0] and k.franges[c, 1] <= k0 + 4 * nt
    fo = twindow.FrameExtractionOptions(dither=0.0)
    x = twindow.preprocess_frames(torch.from_numpy(twindow.extract_frames(
        speechlike(np.random.default_rng(5), 0.6), fo)), fo)[0]
    want = k.reference(x)
    ks = k.kp // 8
    fw = torch.zeros((x.shape[0], k.kp))
    fw[:, :k.win_size] = x * k.window
    parts = torch.zeros((x.shape[0], k.n_cols))
    for k0, nt, m0, m1, toff in k.groups:
        hi_, lo_ = from_fragment_order(
            k.tables[toff:toff + ks * nt * 128].reshape(ks, nt, 32, 4))
        y = fw @ (hi_ + lo_)
        power = y[:, 0::2] ** 2 + y[:, 1::2] ** 2
        for c in range(m0, m1):
            lo, hi = k.franges[c]
            parts[:, c] = power[:, lo - k0:hi - k0] @ torch.from_numpy(
                melw[woff[c]:woff[c] + hi - lo])
    got = torch.stack([parts[:, cols[off[m]:off[m + 1]]].sum(1)
                       for m in range(k.n_mel)], 1)
    got = torch.log(torch.clamp_min(got, tfbank._EPS))
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)


def test_banks_without_wide_filters_keep_one_launch():
    """A bank whose filters all fit a group is laid out as before: no
    pieces, one kernel column per filter."""
    k = CudaFbank(twindow.FrameExtractionOptions(),
                  tmel.MelBanksOptions(num_bins=18), device="cpu")
    assert k.piece_off is None and k.n_cols == k.n_mel == 18


def _gmm_pair(rng, P=11, M=4, D=39):
    w = rng.dirichlet(np.ones(M), size=P)
    m = rng.standard_normal((P, M, D))
    v = 0.5 + rng.random((P, M, D))
    return jgmm.AmDiagGmm(w, m, v), AmDiagGmm(w, m, v, device="cpu")


def test_gmm_decodable_provider_matches_jax(batch_waves):
    jfe, tfe = _frontends("mfcc", True, True)
    jam, tam = _gmm_pair(np.random.default_rng(8))
    want = np.asarray(jbatch.GmmDecodableProvider(jfe, jam)(batch_waves))
    provider = tbatch.GmmDecodableProvider(tfe, tam)
    got = provider(batch_waves)
    assert got.shape == want.shape == (3, 48, 11)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    feats = tfe(batch_waves)
    for b in range(3):
        torch.testing.assert_close(got[b], tam.loglikes(feats[b]),
                                   atol=1e-4, rtol=0)
    assert tam.device_params().launches == 0


def test_gmm_decodable_provider_wants_one_device():
    from kaldi_tpu_torch.core.logging import KaldiError
    _, tfe = _frontends("mfcc", False, True)
    _, tam = _gmm_pair(np.random.default_rng(9))
    tfe.device = torch.device("meta")
    with pytest.raises(KaldiError):
        tbatch.GmmDecodableProvider(tfe, tam)


# -- host numpy copies: equal bit for bit -------------------------------

@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("center", [True, False])
def test_sliding_window_cmn_equals_jax(center, norm_vars):
    feats = (np.random.default_rng(4).standard_normal((130, 5)) * 3
             + 5).astype(np.float32)
    for window in (10, 100, 600):
        kw = dict(cmn_window=window, min_window=20, center=center,
                  normalize_variance=norm_vars)
        got = tfunctions.sliding_window_cmn(
            feats, tfunctions.SlidingWindowCmnOptions(**kw))
        want = jfunctions.sliding_window_cmn(
            feats, jfunctions.SlidingWindowCmnOptions(**kw))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_sliding_window_cmn_global_when_window_covers():
    """tests/test_features.py::test_sliding_cmn on the port."""
    feats = (np.random.default_rng(0).standard_normal((30, 4)) + 5).astype(
        np.float32)
    out = tfunctions.sliding_window_cmn(
        feats, tfunctions.SlidingWindowCmnOptions(cmn_window=100))
    np.testing.assert_allclose(out, feats - feats.mean(axis=0), atol=1e-4)


@pytest.mark.parametrize("rates", [(16000.0, 8000.0), (16000.0, 4000.0),
                                   (8000.0, 16000.0), (16000.0, 11025.0)])
def test_linear_resample_equals_jax(rates):
    wave = speechlike(np.random.default_rng(6), 0.1, rates[0])
    got = tresample.linear_resample(wave, *rates)
    want = jresample.linear_resample(wave, *rates)
    assert got.dtype == np.float32
    assert len(got) == int(len(wave) * rates[1] / rates[0])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(Exception, match="Nyquist"):
        tresample.linear_resample(wave, *rates, filter_cutoff=rates[1])


@pytest.mark.parametrize("samp_freq", [16000.0, 8000.0])
def test_pitch_equals_jax(samp_freq):
    """compute_kaldi_pitch and process_pitch on a voiced tone over noise,
    as tests/test_lm_kws_misc.py drives the original."""
    rng = np.random.default_rng(7)
    n = int(0.8 * samp_freq)
    t = np.arange(n) / samp_freq
    wave = (0.3 * np.sin(2 * np.pi * 150.0 * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)
    got = tpitch.compute_kaldi_pitch(
        wave, tpitch.PitchExtractionOptions(samp_freq=samp_freq))
    want = jpitch.compute_kaldi_pitch(
        wave, jpitch.PitchExtractionOptions(samp_freq=samp_freq))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (78, 2)
    assert abs(float(np.median(got[:, 1])) - 150.0) < 5.0
    for kw in ({}, {"pov_scale": 1.0, "normalization_window": 21}):
        np.testing.assert_array_equal(tpitch.process_pitch(got, **kw),
                                      jpitch.process_pitch(want, **kw))
    assert tpitch.process_pitch(got[:0]).shape == (0, 3)
