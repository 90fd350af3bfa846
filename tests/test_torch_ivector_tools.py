"""The port's VAD, global-GMM and i-vector tools against the JAX package's,
through ``kaldi_tpu_torch.cli.tools.main`` (``--device=cpu`` where the
tool computes with tensors) and ``kaldi_tpu.cli.tools.main`` on the same
files: 13-dimensional features of 6 seeded utterances (C0 energy in
column 0, frames around 8 seeded centers) and a spk2utt of 2 speakers.

Each step of the steps/online/nnet2 recipe (gmm-global-init-from-feats →
gmm-global-acc-stats → gmm-global-est → ivector-extractor-init →
ivector-extractor-acc-stats → ivector-extractor-sum-accs →
ivector-extractor-est → ivector-extract-online2) starts both sides from
the JAX side's previous output, so each tool is held on its own:
  * host code and the same draws give the same bytes (extractor init,
    copy, sum-accs) or equal outputs (select-voiced-frames, gmm-global-est
    at 1e-12);
  * float32 device sums in another order (the global GMM's accumulators
    and its EM): rtol 1e-5 against the accumulators' largest magnitude,
    1e-4 after gmm-global-init-from-feats' 6 EM iterations;
  * float64 i-vector work written as float32 (the stats file, ivector-
    extract, ivector-extract-online2): 1e-6 relative to the largest
    magnitude; written as float64 (the estimated extractor,
    ivector-extract-online): 1e-9 relative;
  * compute-vad's decisions: equal.
Also ``online2-wav-nnet3-latgen-faster --ivector-extractor`` against the
JAX tool on the yes/no task with a 13 + 4-input TDNN-F: equal words.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.cli import tools_bank7
from kaldi_tpu_torch.am.ivector import read_ivector_extractor
from kaldi_tpu_torch.cli import online2
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli.tools_bank5 import _read_global_gmm
from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
from kaldi_tpu_torch.cli.tools_ivector import _read_iv_stats
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)

D, K = 13, 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ivtools")
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((8, D)) * 3
    with TableWriter(f"ark:{d / 'feats.ark'}", holder="mat") as w:
        for i in range(6):
            T = 60 + 13 * i
            x = centers[rng.integers(0, 8, T)] + rng.standard_normal((T, D))
            x[:, 0] = 10.0 * rng.random(T) - 3.0 * (np.arange(T) % 7 == 0)
            w[f"utt{i}"] = x.astype(np.float32)
    with TableWriter(f"ark,t:{d / 'spk2utt'}", holder="text") as w:
        w["spkA"] = ["utt0", "utt2", "utt4"]
        w["spkB"] = ["utt1", "utt3", "utt5"]
    # the recipe's inputs to each later step, from the JAX tools
    steps = [
        ["gmm-global-init-from-feats", "--num-gauss=8", "--num-iters=6",
         f"ark:{d}/feats.ark", f"{d}/ubm0"],
        ["gmm-global-acc-stats", f"{d}/ubm0", f"ark:{d}/feats.ark",
         f"{d}/ubm.acc"],
        ["gmm-global-est", f"{d}/ubm0", f"{d}/ubm.acc", f"{d}/ubm"],
        ["ivector-extractor-init", f"--ivector-dim={K}", "--seed=3",
         f"{d}/ubm", f"{d}/0.ie"],
        ["ivector-extractor-acc-stats", f"{d}/0.ie", f"ark:{d}/feats.ark",
         f"{d}/acc.1"],
        ["ivector-extractor-est", f"{d}/0.ie", f"{d}/acc.1", f"{d}/1.ie"],
        ["compute-vad", f"ark:{d}/feats.ark", f"ark:{d}/vad.ark"]]
    for argv in steps:
        assert jtools.main(argv) == 0, argv[0]
    return d


def _both(d, name, args, port_opts=("--device=cpu",)):
    """Run ``name`` on both sides; ``{out}`` in args → a per-side path."""
    outs = {}
    for side, main, extra in (("port", ttools.main, list(port_opts)),
                              ("jax", jtools.main, [])):
        out = str(d / f"{name}.{side}")
        assert main([name, *extra,
                     *[a.format(d=d, out=out) for a in args]]) == 0, side
        outs[side] = out
    return outs["port"], outs["jax"]


def _table(path, holder):
    return dict(SequentialTableReader(path, holder=holder))


def _rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_compute_vad_equals_jax(files):
    port, jax = _both(files, "compute-vad", ["ark:{d}/feats.ark",
                                             "ark:{out}"])
    got, want = _table(f"ark:{port}", "vec"), _table(f"ark:{jax}", "vec")
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert 0 < sum(v.sum() for v in got.values()) < \
        sum(len(v) for v in got.values())


def test_select_voiced_frames_equals_jax(files):
    port, jax = _both(files, "select-voiced-frames",
                      ["ark:{d}/feats.ark", "ark:{d}/vad.ark", "ark:{out}"],
                      port_opts=())
    got, want = _table(f"ark:{port}", "mat"), _table(f"ark:{jax}", "mat")
    assert sorted(got) == sorted(want) != []
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _ubm(path):
    return _read_global_gmm(path, "cpu")


def test_gmm_global_init_from_feats_matches_jax(files):
    port, jax = _both(files, "gmm-global-init-from-feats",
                      ["--num-gauss=8", "--num-iters=6",
                       "ark:{d}/feats.ark", "{out}"])
    got, want = _ubm(port), _ubm(jax)
    assert got.num_pdfs == 1 and got.num_gauss() == want.num_gauss() == 8
    for name in ("weights", "means", "vars"):
        _rel(getattr(got, name), getattr(want, name), 1e-4)


def test_gmm_global_acc_stats_matches_jax(files):
    port, jax = _both(files, "gmm-global-acc-stats",
                      ["{d}/ubm0", "ark:{d}/feats.ark", "{out}"])
    pa, ja = read_gmm_accs(port), read_gmm_accs(jax)
    for name in ("occ", "mean_acc", "var_acc"):
        _rel(getattr(pa, name), getattr(ja, name), 1e-5)
    assert pa.tot_frames == ja.tot_frames > 0


def test_gmm_global_est_equals_jax(files):
    port, jax = _both(files, "gmm-global-est",
                      ["--mix-up=10", "{d}/ubm0", "{d}/ubm.acc", "{out}"],
                      port_opts=())
    got, want = _ubm(port), _ubm(jax)
    assert got.num_gauss() == want.num_gauss() == 10
    for name in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=1e-12)


def test_gmm_global_get_post_matches_jax(files):
    port, jax = _both(files, "gmm-global-get-post",
                      ["--n=3", "{d}/ubm", "ark:{d}/feats.ark", "ark:{out}"])
    got, want = _table(f"ark:{port}", "post"), _table(f"ark:{jax}", "post")
    assert sorted(got) == sorted(want) != []
    for k in want:
        assert len(got[k]) == len(want[k])
        for g, w in zip(got[k], want[k]):
            # the Gaussians that carry the frame (a posterior above 1e-3)
            # in the same order, their posteriors within float32 rounding
            gs = [(i, p) for i, p in g if p > 1e-3]
            ws = [(i, p) for i, p in w if p > 1e-3]
            assert [i for i, _ in gs] == [i for i, _ in ws]
            np.testing.assert_allclose([p for _, p in gs],
                                       [p for _, p in ws], rtol=1e-4,
                                       atol=1e-6)


def test_ivector_extractor_init_and_copy_write_the_jax_bytes(files):
    port, jax = _both(files, "ivector-extractor-init",
                      [f"--ivector-dim={K}", "--seed=3", "{d}/ubm", "{out}"])
    _same_bytes(port, jax)
    port, jax = _both(files, "ivector-extractor-copy", ["{d}/1.ie", "{out}"],
                      port_opts=())
    _same_bytes(port, jax)
    # the reader rounds to float32 (core/io.py, as the original's), so
    # the copy holds the values the original file reads back as
    copy = read_ivector_extractor(port, device="cpu")
    orig = read_ivector_extractor(str(files / "1.ie"), device="cpu")
    for name in ("means", "inv_vars", "weights", "T"):
        assert torch.equal(getattr(copy, name), getattr(orig, name)), name


def test_ivector_extractor_acc_stats_matches_jax(files):
    port, jax = _both(files, "ivector-extractor-acc-stats",
                      ["{d}/0.ie", "ark:{d}/feats.ark", "{out}"])
    got, want = _read_iv_stats(port), _read_iv_stats(jax)
    assert sorted(got) == ["A", "B", "gamma", "num_utts"]
    assert int(got["num_utts"]) == int(want["num_utts"]) == 6
    for k in ("A", "B", "gamma"):
        _rel(got[k], want[k], 1e-6)


def test_ivector_extractor_sum_accs_equals_jax(files):
    port, jax = _both(files, "ivector-extractor-sum-accs",
                      ["{out}", "{d}/acc.1", "{d}/acc.1"], port_opts=())
    _same_bytes(port, jax)
    tot = _read_iv_stats(port)
    np.testing.assert_array_equal(tot["gamma"],
                                  2 * _read_iv_stats(str(files / "acc.1"))["gamma"])


def test_ivector_extractor_est_matches_jax(files):
    port, jax = _both(files, "ivector-extractor-est",
                      ["{d}/0.ie", "{d}/acc.1", "{out}"])
    got = read_ivector_extractor(port, device="cpu")
    want = read_ivector_extractor(jax, device="cpu")
    _rel(got.T, want.T, 1e-9)
    before = read_ivector_extractor(str(files / "0.ie"), device="cpu")
    assert not torch.equal(got.T, before.T)


def test_ivector_extract_matches_jax(files):
    port, jax = _both(files, "ivector-extract",
                      ["{d}/1.ie", "ark:{d}/feats.ark", "ark:{out}"])
    got, want = _table(f"ark:{port}", "vec"), _table(f"ark:{jax}", "vec")
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        assert got[k].shape == (K,)
        _rel(got[k], want[k], 1e-6)


@pytest.mark.parametrize("opts", [[], ["--ivector-period=7",
                                       "--max-count=30"]])
def test_ivector_extract_online_matches_jax(files, opts):
    port, jax = _both(files, "ivector-extract-online",
                      [*opts, "{d}/1.ie", "ark:{d}/feats.ark", "ark:{out}"])
    got, want = _table(f"ark:{port}", "mat"), _table(f"ark:{jax}", "mat")
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        _rel(got[k], want[k], 1e-9)


def test_ivector_extract_online2_matches_jax(files):
    port, jax = _both(files, "ivector-extract-online2",
                      ["ark:{d}/spk2utt", "{d}/1.ie", "ark:{d}/feats.ark",
                       "ark:{out}"])
    got, want = _table(f"ark:{port}", "mat"), _table(f"ark:{jax}", "mat")
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        assert got[k].shape[1] == K
        _rel(got[k], want[k], 1e-6)


@pytest.fixture(scope="module")
def online2_files(tmp_path_factory, files):
    """The yes/no task's .mdl and HCLG.fst, a raw nnet3 TDNN-F of 13 + K
    inputs (seeded), an extractor over 13-dimensional features and two
    waveforms, all written by the port."""
    from kaldi_tpu_torch.am import nnet3_io
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    from test_torch_beam import PORT, yesno_graph
    from test_torch_online_nnet import numpy_state
    d = tmp_path_factory.mktemp("online2_ivector")
    _, tm, HCLG = yesno_graph(PORT, "three_state")
    P = tm.num_pdfs
    write_mdl(str(d / "final.mdl"), tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device="cpu"))
    write_fst_path(str(d / "HCLG.fst"), HCLG)
    cfg = TdnnConfig(feat_dim=13 + K, num_pdfs=P, hidden_dim=32,
                     bottleneck_dim=8, num_layers=3)
    rng = np.random.default_rng(17)
    nnet3_io.write_raw_model(str(d / "final.raw"),
                             numpy_state(TdnnChain(cfg), rng), cfg)
    with TableWriter(f"ark:{d / 'wav.ark'}", holder="wav") as w:
        for i, n in enumerate((9000, 12340)):
            t = np.arange(n) / 16000.0
            x = 2000 * np.sin(2 * np.pi * (150 + 80 * i) * t) \
                + 300 * rng.standard_normal(n)
            w[f"utt{i}"] = (x.astype(np.int16), 16000)
    return d, files / "1.ie"


@pytest.mark.parametrize("period", [10, 25])
def test_online2_with_ivector_extractor_matches_jax(online2_files, period):
    d, extractor = online2_files
    args = [f"--ivector-extractor={extractor}",
            f"--ivector-period={period}", str(d / "final.mdl"),
            str(d / "final.raw"), str(d / "HCLG.fst"), f"ark:{d / 'wav.ark'}"]
    assert online2.online2_wav_nnet3_latgen_faster(
        ["--device=cpu"] + args + [f"ark,t:{d / 'port.txt'}"]) == 0
    assert tools_bank7.online2_wav_nnet3_latgen_faster(
        args + [f"ark,t:{d / 'jax.txt'}"]) == 0
    got = _table(f"ark,t:{d / 'port.txt'}", "text")
    want = _table(f"ark,t:{d / 'jax.txt'}", "text")
    assert sorted(got) == ["utt0", "utt1"]
    assert got == want
    assert any(got.values())
