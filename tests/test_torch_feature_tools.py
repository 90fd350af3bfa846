"""The port's tool registry and its feature tools against the JAX
package's.

Each of the 15 feature tools runs through
``kaldi_tpu_torch.cli.tools.main`` (``--device=cpu`` for those that
compute with tensors: the wave and feature computers, CMVN, deltas,
splicing and transforms) and ``kaldi_tpu.cli.tools.main`` on the same
wav or feature archive, and their outputs are compared with the
tolerances of the library tests (tests/test_torch_features.py,
tests/test_torch_frontend.py):

* compute-mfcc-feats: 2e-3 · lifter_k on cepstrum k (log-mel by DFT
  products against an FFT), 1e-4 on the energy column;
  compute-fbank-feats: 2e-3 log-mel; compute-plp-feats: atol 1e-4 +
  rtol 1e-4; compute-spectrogram-feats: 2e-3 log power on bins of at
  least 1e-5 of the frame's largest, power within 1e-5 of that bin
  everywhere, 1e-4 on the energy column;
* compute-cmvn-stats: float64 sums, rtol 1e-12; apply-cmvn, add-deltas,
  splice-feats, transform-feats: float32 rounding, atol 1e-5 (1e-4 for
  the transform's product);
* copy-feats, apply-cmvn-sliding, resample-wav and the three pitch tools
  are host numpy on both sides: equal bit for bit.

The registry lists the port's four earlier tools beside these, and
dispatches as the original's does (usage, unknown tools, a KaldiError
→ rc 1).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core import io as tio
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.features.compute import compute_lifter_coeffs

from test_torch_frontend import assert_spectra_close

torch.set_num_threads(1)

FEATURE_TOOLS = [
    "compute-mfcc-feats", "compute-fbank-feats", "compute-plp-feats",
    "copy-feats", "compute-cmvn-stats", "apply-cmvn", "add-deltas",
    "splice-feats", "transform-feats", "resample-wav",
    "compute-spectrogram-feats", "apply-cmvn-sliding",
    "compute-kaldi-pitch-feats", "process-kaldi-pitch-feats",
    "compute-and-process-kaldi-pitch-feats"]
EARLIER_TOOLS = ["gmm-latgen-faster", "online2-wav-nnet3-latgen-faster",
                 "nnet3-chain-train", "nnet3-chain-compute-prob"]


@pytest.fixture(scope="module")
def arks(tmp_path_factory):
    """A wav archive of 3 int16 utterances (voiced tones over noise,
    0.6-1.0 s at 16 kHz), a feature archive of 3 seeded (T, 13)
    matrices, spk2utt / utt2spk maps and an affine 13 → 10 transform."""
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(21)
    with TableWriter(f"ark:{d / 'wav.ark'}", holder="wav") as w:
        for i, secs in enumerate((0.6, 1.0, 0.8)):
            t = np.arange(int(16000 * secs)) / 16000.0
            x = 300.0 * rng.standard_normal(len(t)) + 4000.0 * np.sin(
                2 * np.pi * (110.0 + 40 * i) * t) * (1 + 0.5 * np.sin(5 * t))
            w[f"utt{i}"] = (np.clip(x, -32768, 32767).astype(np.int16), 16000)
    with TableWriter(f"ark:{d / 'feats.ark'}", holder="mat") as w:
        for i, n in enumerate((40, 57, 33)):
            w[f"utt{i}"] = (rng.standard_normal((n, 13)) * 2 + 3).astype(
                np.float32)
    (d / "spk2utt").write_text("spkA utt0 utt2\nspkB utt1\n")
    (d / "utt2spk").write_text("utt0 spkA\nutt1 spkB\nutt2 spkA\n")
    with open(d / "lda.mat", "wb") as f:
        tio.init_kaldi_output_stream(f)
        tio.write_matrix(f, rng.standard_normal((10, 14)).astype(np.float32))
    return d


def run_both(arks, name, args, port_opts=("--device=cpu",), holder="mat"):
    """Run ``name`` on both sides; ``args`` are its positional arguments
    with the output written last as ``{out}``.  → {key: (port, jax)}."""
    outs = {}
    for side, main, extra in (("port", ttools.main, list(port_opts)),
                              ("jax", jtools.main, [])):
        out = arks / f"{name}.{side}.ark"
        argv = [a.format(d=arks, out=f"ark:{out}") for a in args]
        assert main([name, *extra, *argv]) == 0, (side, name)
        outs[side] = dict(SequentialTableReader(f"ark:{out}", holder=holder))
    assert sorted(outs["port"]) == sorted(outs["jax"]) != []
    return {k: (outs["port"][k], outs["jax"][k]) for k in outs["port"]}


WAV = "ark:{d}/wav.ark"
FEATS = "ark:{d}/feats.ark"


def test_compute_mfcc_feats_matches_jax(arks):
    tol = 2e-3 * compute_lifter_coeffs(22.0, 13)
    tol[0] = 1e-4
    for got, want in run_both(arks, "compute-mfcc-feats",
                              [WAV, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 13
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max(0)


def test_compute_fbank_feats_matches_jax(arks):
    for got, want in run_both(arks, "compute-fbank-feats",
                              ["--num-mel-bins=40", WAV, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 40
        assert want.min() > 1.0
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_compute_plp_feats_matches_jax(arks):
    for got, want in run_both(arks, "compute-plp-feats",
                              [WAV, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 13
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_compute_spectrogram_feats_matches_jax(arks):
    for got, want in run_both(arks, "compute-spectrogram-feats",
                              [WAV, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 257
        assert_spectra_close(got, want)


@pytest.mark.parametrize("compress", [False, True])
def test_copy_feats_equals_jax(arks, compress):
    for got, want in run_both(arks, "copy-feats",
                              [f"--compress={str(compress).lower()}", FEATS,
                               "{out}"], port_opts=()).values():
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spk", [False, True], ids=["utt", "spk"])
def test_compute_cmvn_stats_matches_jax(arks, spk):
    args = ([f"--spk2utt={arks}/spk2utt"] if spk else []) + [FEATS, "{out}"]
    res = run_both(arks, "compute-cmvn-stats", args)
    assert sorted(res) == (["spkA", "spkB"] if spk
                           else ["utt0", "utt1", "utt2"])
    for got, want in res.values():
        assert got.shape == want.shape == (2, 14)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_apply_cmvn_matches_jax(arks, norm_vars):
    # both sides apply the JAX side's per-speaker stats
    assert jtools.main(["compute-cmvn-stats", f"--spk2utt={arks}/spk2utt",
                        f"ark:{arks}/feats.ark",
                        f"ark:{arks}/stats.ark"]) == 0
    res = run_both(arks, "apply-cmvn",
                   [f"--norm-vars={str(norm_vars).lower()}",
                    f"--utt2spk={arks}/utt2spk", "ark:{d}/stats.ark",
                    FEATS, "{out}"])
    for got, want in res.values():
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_add_deltas_matches_jax(arks):
    for got, want in run_both(arks, "add-deltas",
                              ["--delta-order=2", FEATS, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 39
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_splice_feats_matches_jax(arks):
    for got, want in run_both(arks, "splice-feats",
                              ["--left-context=3", "--right-context=2",
                               FEATS, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 13 * 6
        np.testing.assert_array_equal(got, want)


def test_transform_feats_matches_jax(arks):
    for got, want in run_both(arks, "transform-feats",
                              ["{d}/lda.mat", FEATS, "{out}"]).values():
        assert got.shape == want.shape and got.shape[1] == 10
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_resample_wav_equals_jax(arks):
    res = run_both(arks, "resample-wav", ["--target-rate=8000", WAV,
                                          "{out}"],
                   port_opts=(), holder="wav")
    for (got, rate), (want, jrate) in res.values():
        assert rate == jrate == 8000
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("center", [True, False])
def test_apply_cmvn_sliding_equals_jax(arks, center):
    for got, want in run_both(arks, "apply-cmvn-sliding",
                              ["--cmn-window=20", "--norm-vars=true",
                               f"--center={str(center).lower()}", FEATS,
                               "{out}"], port_opts=()).values():
        np.testing.assert_array_equal(got, want)


def test_pitch_tools_equal_jax(arks):
    pitch = run_both(arks, "compute-kaldi-pitch-feats",
                     ["--max-f0=300", WAV, "{out}"], port_opts=())
    for got, want in pitch.values():
        assert got.shape[1] == 2
        np.testing.assert_array_equal(got, want)
    os.replace(arks / "compute-kaldi-pitch-feats.jax.ark",
               arks / "pitch.ark")
    for got, want in run_both(arks, "process-kaldi-pitch-feats",
                              ["--pov-scale=1.5", "ark:{d}/pitch.ark",
                               "{out}"], port_opts=()).values():
        assert got.shape[1] == 3
        np.testing.assert_array_equal(got, want)


def test_compute_and_process_pitch_equals_jax(arks):
    for got, want in run_both(arks, "compute-and-process-kaldi-pitch-feats",
                              [WAV, "{out}"], port_opts=()).values():
        assert got.shape[1] == 3
        np.testing.assert_array_equal(got, want)


def test_pitch_tools_keep_the_wave_scale_quirk(arks):
    """compute-kaldi-pitch-feats divides the wave by 32768 and
    compute-and-process-kaldi-pitch-feats does not, as in the original.
    The NCCF's ballast is scaled by the signal's own mean square, and
    32768 is a power of two, so the two still agree bit for bit."""
    out = {}
    for name in ("compute-kaldi-pitch-feats",
                 "compute-and-process-kaldi-pitch-feats"):
        path = arks / f"{name}.quirk.ark"
        assert ttools.main([name, f"ark:{arks}/wav.ark",
                            f"ark:{path}"]) == 0
        out[name] = dict(SequentialTableReader(f"ark:{path}"))
    from kaldi_tpu_torch.features.pitch import (compute_kaldi_pitch,
                                                process_pitch)
    wave = dict(SequentialTableReader(f"ark:{arks}/wav.ark",
                                      holder="wav"))["utt0"][0]
    np.testing.assert_array_equal(
        out["compute-kaldi-pitch-feats"]["utt0"],
        compute_kaldi_pitch(wave / 32768.0))
    for key, pitch in out["compute-kaldi-pitch-feats"].items():
        np.testing.assert_array_equal(
            process_pitch(pitch),
            out["compute-and-process-kaldi-pitch-feats"][key])


# -- the registry -------------------------------------------------------

def test_registry_lists_every_tool(capsys):
    for name in FEATURE_TOOLS + EARLIER_TOOLS:
        assert name in ttools.TOOLS, name
    assert ttools.main(["--help"]) == 1
    listed = capsys.readouterr().err.split()
    assert set(FEATURE_TOOLS + EARLIER_TOOLS) <= set(listed)
    assert ttools.main([]) == 1
    assert ttools.main(["no-such-tool"]) == 1
    assert "Unknown tool" in capsys.readouterr().err


@pytest.mark.parametrize("name", EARLIER_TOOLS)
def test_registry_reaches_the_earlier_tools(name, capsys):
    """Each earlier tool, through the registry, prints its own usage on
    a wrong argument count."""
    assert ttools.main([name, "--device=cpu", "only-one-arg"]) == 1
    err = capsys.readouterr().err
    assert name in err and "--device" in err


@pytest.mark.parametrize("name", ["compute-mfcc-feats", "compute-plp-feats",
                                  "compute-spectrogram-feats",
                                  "compute-cmvn-stats", "apply-cmvn",
                                  "add-deltas", "splice-feats",
                                  "transform-feats"])
def test_tensor_tools_default_to_the_card(name, arks, capsys, monkeypatch):
    """Without a card, a tool that computes with tensors stops with the
    port's "no CUDA card" error (rc 1) unless given --device=cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"apply-cmvn": ["ark:x", FEATS, "{out}"],
            "transform-feats": ["{d}/lda.mat", FEATS, "{out}"]}.get(
        name, [WAV if name.startswith("compute-") and name.endswith("-feats")
               else FEATS, "{out}"])
    argv = [a.format(d=arks, out=f"ark:{arks}/nocard.ark") for a in args]
    assert ttools.main([name, *argv]) == 1
    assert "no CUDA card" in capsys.readouterr().err


def test_wrong_sample_rate_is_an_error(arks, capsys):
    assert ttools.main(["compute-fbank-feats", "--device=cpu",
                        "--sample-frequency=8000", f"ark:{arks}/wav.ark",
                        f"ark:{arks}/bad.ark"]) == 1
    assert "sample rate" in capsys.readouterr().err


def test_module_entry_point_lists_the_tools():
    """``python -m kaldi_tpu_torch.cli`` with no tool lists them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "kaldi_tpu_torch.cli"],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1
    assert "compute-mfcc-feats" in res.stderr
    assert "nnet3-chain-train" in res.stderr
