"""The port's fan-out decode tools (kaldi_tpu_torch/cli/tools_parallel.py)
against the JAX package's tools of the same names, on the CPU.

A module fixture runs kaldi_tpu/pipelines/wav_recipe.py at
test_torch_gmm_slice.py's size (final.mdl, a binary HCLG.fst and the test
features), writes the port's GMM log-likelihoods of the test features as
a matrix archive and a seeded narrow TDNN-F as a raw nnet3 file.  Each
tool of the port and of the JAX package then runs on the same files: the
lattices must give the same words with costs within 1e-3 (the two
packages' log-likelihoods differ at ~1e-5), and each ``-parallel`` tool
of the port equals its serial form to the bit.
"""

import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import TOOLS as JTOOLS
from kaldi_tpu.pipelines import wav_recipe
from kaldi_tpu_torch.cli import TOOLS
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)

NEW = ["latgen-faster-mapped", "latgen-faster-mapped-parallel",
       "gmm-latgen-faster-parallel", "nnet3-latgen-faster-parallel"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from kaldi_tpu_torch.am import nnet3_io
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    from test_torch_online_nnet import numpy_state
    d = tmp_path_factory.mktemp("parallel_tools")
    work = str(d / "wavwork")
    wer = wav_recipe.run(work, num_utts=12, num_test=6, num_iters=5,
                         totgauss=60)
    assert wer.wer == 0.0
    exp = os.path.join(work, "exp", "mono")
    p = dict(mdl=os.path.join(exp, "final.mdl"),
             fst=os.path.join(exp, "graph", "HCLG.fst"),
             words=os.path.join(exp, "graph", "words.txt"),
             feats=f"scp:{os.path.join(work, 'mfcc', 'final_test.scp')}",
             loglikes=f"ark:{d / 'loglikes.ark'}", raw=str(d / "final.raw"))
    tm, am = read_mdl(p["mdl"], device="cpu")
    dim = 0
    with TableWriter(p["loglikes"], holder="mat") as w:
        for key, feats in SequentialTableReader(p["feats"], holder="mat"):
            w[key] = am.loglikes(feats).numpy()
            dim = feats.shape[1]
    cfg = TdnnConfig(feat_dim=dim, num_pdfs=tm.num_pdfs, hidden_dim=32,
                     bottleneck_dim=8, num_layers=2)
    nnet3_io.write_raw_model(p["raw"], numpy_state(
        TdnnChain(cfg), np.random.default_rng(23)), cfg)
    return p


def _run(tools, name, argv):
    assert tools[name](argv) == 0, name


def _lattices(path):
    return dict(SequentialTableReader(f"ark:{path}", holder="clat"))


def _same(got, want, tol):
    """Equal keys in order, equal best-path words, path costs within
    tol."""
    assert list(got) == list(want)
    assert got
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        assert gw == ww, k
        assert gc == pytest.approx(wc, abs=tol), k
        assert dict(got[k].paths()) == pytest.approx(dict(want[k].paths()),
                                                     abs=tol), k


def test_the_tools_are_registered():
    for name in NEW:
        assert name in TOOLS and name in JTOOLS


@pytest.mark.parametrize("name", NEW)
def test_wrong_argument_counts_print_the_usage(name):
    assert TOOLS[name](["--device=cpu", "only-one-arg"]) == 1


def test_latgen_faster_mapped(files, tmp_path):
    """Lattices and words from the log-likelihood archive equal the JAX
    tool's on the same files."""
    args = lambda o: [f"--word-symbol-table={files['words']}",  # noqa: E731
                      files["mdl"], files["fst"], files["loglikes"],
                      f"ark:{o}.lat", f"ark,t:{o}.txt"]
    _run(TOOLS, "latgen-faster-mapped",
         ["--device=cpu"] + args(tmp_path / "port"))
    _run(JTOOLS, "latgen-faster-mapped", args(tmp_path / "jax"))
    _same(_lattices(tmp_path / "port.lat"), _lattices(tmp_path / "jax.lat"),
          1e-3)
    with open(tmp_path / "port.txt") as a, open(tmp_path / "jax.txt") as b:
        text = a.read()
        assert text == b.read()
    assert "YES" in text or "NO" in text


def test_latgen_faster_mapped_parallel(files, tmp_path):
    """Three threads: equal to the JAX tool's lattices, and to the port's
    serial tool's to the bit."""
    args = lambda o: [files["mdl"], files["fst"],  # noqa: E731
                      files["loglikes"], f"ark:{o}"]
    _run(TOOLS, "latgen-faster-mapped-parallel",
         ["--device=cpu", "--num-threads=3"] + args(tmp_path / "port.lat"))
    _run(JTOOLS, "latgen-faster-mapped-parallel",
         ["--num-threads=3"] + args(tmp_path / "jax.lat"))
    _run(TOOLS, "latgen-faster-mapped",
         ["--device=cpu"] + args(tmp_path / "serial.lat"))
    got = _lattices(tmp_path / "port.lat")
    _same(got, _lattices(tmp_path / "jax.lat"), 1e-3)
    _same(got, _lattices(tmp_path / "serial.lat"), 0.0)


def test_gmm_latgen_faster_parallel(files, tmp_path):
    """GMM scoring and decode on three threads: equal to the JAX tool's
    lattices, and to the port's gmm-latgen-faster's to the bit."""
    args = lambda o: [files["mdl"], files["fst"], files["feats"],  # noqa
                      f"ark:{o}"]
    _run(TOOLS, "gmm-latgen-faster-parallel",
         ["--device=cpu", "--num-threads=3"] + args(tmp_path / "port.lat"))
    _run(JTOOLS, "gmm-latgen-faster-parallel",
         ["--num-threads=3"] + args(tmp_path / "jax.lat"))
    _run(TOOLS, "gmm-latgen-faster",
         ["--device=cpu"] + args(tmp_path / "serial.lat"))
    got = _lattices(tmp_path / "port.lat")
    _same(got, _lattices(tmp_path / "jax.lat"), 1e-3)
    _same(got, _lattices(tmp_path / "serial.lat"), 0.0)


def test_nnet3_latgen_faster_parallel(files, tmp_path):
    """The raw TDNN-F's scores decoded on three threads: equal to the JAX
    tool's lattices, and to the port's nnet3-latgen-faster's to the bit
    (at the parallel tool's beams)."""
    opts = ["--beam=13.0", "--lattice-beam=6.0", "--acoustic-scale=1.0",
            "--frame-subsampling-factor=3"]
    args = lambda o: [files["mdl"], files["raw"], files["fst"],  # noqa
                      files["feats"], f"ark:{o}"]
    _run(TOOLS, "nnet3-latgen-faster-parallel",
         ["--device=cpu", "--num-threads=3"] + opts
         + args(tmp_path / "port.lat"))
    _run(JTOOLS, "nnet3-latgen-faster-parallel",
         ["--num-threads=3"] + opts + args(tmp_path / "jax.lat"))
    _run(TOOLS, "nnet3-latgen-faster",
         ["--device=cpu"] + opts
         + args(tmp_path / "serial.lat"))
    got = _lattices(tmp_path / "port.lat")
    _same(got, _lattices(tmp_path / "jax.lat"), 1e-3)
    _same(got, _lattices(tmp_path / "serial.lat"), 0.0)
