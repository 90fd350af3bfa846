"""The port's nnet3-chain-train and nnet3-chain-compute-prob
(kaldi_tpu_torch/cli/chain.py, --device=cpu) against the JAX package's
tools (kaldi_tpu/cli/tools_bank9.py) on the same files, all written by
the JAX package: a .mdl, a raw nnet3 TDNN-F, phone sequences and egs
(mirrors tests/test_cli_bank9.py::test_nnet3_chain_train_cli).  The
trained models agree within 1e-3 of each tensor's largest entry, and so
do the two objectives.
"""

import jax
import numpy as np
import pytest
import torch

from kaldi_tpu.am import chain as jc
from kaldi_tpu.am.gmm import AmDiagGmm
from kaldi_tpu.am.nnet3_io import write_raw_model
from kaldi_tpu.am.serialize import write_mdl
from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig
from kaldi_tpu.am.topology import HmmTopology
from kaldi_tpu.am.transitions import TransitionModel
from kaldi_tpu.am.tree import MonophoneContextDependency
from kaldi_tpu.cli import TOOLS
from kaldi_tpu.core.table import TableWriter
from kaldi_tpu.pipelines.chain import make_chain_egs
from kaldi_tpu.pipelines.egs_io import write_egs_ark
from kaldi_tpu_torch.am import nnet3_io as tio
from kaldi_tpu_torch.cli import chain as tcli

torch.set_num_threads(1)

D = 6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain_cli")
    phones = [1, 2, 3]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    P = tree.num_pdfs
    write_mdl(str(d / "final.mdl"), TransitionModel(topo, tree),
              AmDiagGmm.flat_start(P, np.zeros(D), np.ones(D)))
    cfg = TdnnConfig(feat_dim=D, num_pdfs=P, hidden_dim=16,
                     bottleneck_dim=8, num_layers=2,
                     frame_subsampling_factor=3)
    variables = TdnnChain(cfg).init(jax.random.PRNGKey(0),
                                    np.zeros((2, 12, D)), train=False)
    write_raw_model(str(d / "0.raw"), variables["params"],
                    variables["batch_stats"], cfg)
    rng = np.random.default_rng(0)
    seqs = [[int(p) for p in rng.choice(phones, 6)] for _ in range(4)]
    with TableWriter(f"ark:{d}/ph.ark", holder="ivec") as w:
        for u, s in enumerate(seqs):
            w[f"u{u}"] = np.asarray(s, np.int32)
    runs = {f"u{i}": [(int(rng.integers(1, 4)), int(rng.integers(3, 9)))
                      for _ in range(10)] for i in range(3)}
    feats = {u: rng.standard_normal((sum(n for _, n in r), D))
             .astype(np.float32) for u, r in runs.items()}
    den = jc.make_denominator_graph(seqs, tree, topo, order=3)
    write_egs_ark(f"ark:{d}/egs.ark", make_chain_egs(
        feats, runs, tree, topo, chunk_size=24, subsample=3, den=den))
    return d


def _args(d, raw):
    return [str(d / "final.mdl"), str(d / raw), f"ark:{d}/ph.ark",
            f"ark:{d}/egs.ark"]


@pytest.fixture(scope="module")
def trained(files):
    """Each package's nnet3-chain-train output from the same files."""
    opts = ["--num-epochs=2", "--learning-rate=5e-3"]
    assert TOOLS["nnet3-chain-train"](
        opts + _args(files, "0.raw") + [str(files / "jax.raw")]) == 0
    assert tcli.main(["nnet3-chain-train", "--device=cpu"] + opts
                     + _args(files, "0.raw")
                     + [str(files / "port.raw")]) == 0
    return files


def test_chain_train_cli_matches_jax(trained):
    model = tio.read_nnet3_path(str(trained / "port.raw"))
    cfg = tio.infer_tdnn_config(model)
    got = tio.read_raw_model(str(trained / "port.raw"), cfg)
    want = tio.read_raw_model(str(trained / "jax.raw"), cfg)
    start = tio.read_raw_model(str(trained / "0.raw"), cfg)
    moved = 0.0
    for k in want:
        scale = max(float(want[k].abs().max()), 1e-6)
        assert float((got[k] - want[k]).abs().max()) / scale < 1e-3, k
        moved += float((got[k] - start[k]).abs().max())
    assert moved > 0


@pytest.mark.parametrize("raw", ["0.raw", "jax.raw"])
def test_chain_compute_prob_matches_jax(trained, raw, capsys):
    capsys.readouterr()
    assert TOOLS["nnet3-chain-compute-prob"](_args(trained, raw)) == 0
    want = float(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["nnet3-chain-compute-prob", "--device=cpu"]
                     + _args(trained, raw)) == 0
    got = float(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(got)
    assert got == pytest.approx(want, abs=1e-3)


def test_cli_defaults_to_the_card_and_checks_arguments(capsys):
    assert tcli.main(["nnet3-chain-train", "only.mdl"]) == 1
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if "--device" in ln]
    assert line and line[0].rstrip().endswith("default = cuda)")
    assert tcli.main(["no-such-tool"]) == 1
    assert "nnet3-chain-compute-prob" in capsys.readouterr().err
