"""The port's online2-wav-nnet3-latgen-faster against kaldi_tpu's tool.

Both tools read the same files: a ``.mdl`` and a binary ``HCLG.fst`` of
the yes/no task and a raw nnet3 TDNN-F (13 MFCC inputs, seeded weights),
all written by the port, and two short waveforms.  The graph is under
20,000 states, so both take the SingleUtteranceDecoder branch; their
words must be equal.
"""

import inspect

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools_bank7
from kaldi_tpu_torch.am import nnet3_io as tio
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import write_mdl
from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
from kaldi_tpu_torch.cli import online2
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.fst.openfst_io import write_fst_path
from test_torch_beam import PORT, yesno_graph
from test_torch_online_nnet import numpy_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("online2")
    _, tm, HCLG = yesno_graph(PORT, "three_state")
    P = tm.num_pdfs
    write_mdl(str(d / "final.mdl"), tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device="cpu"))
    write_fst_path(str(d / "HCLG.fst"), HCLG)
    cfg = TdnnConfig(feat_dim=13, num_pdfs=P, hidden_dim=32,
                     bottleneck_dim=8, num_layers=3)
    rng = np.random.default_rng(17)
    tio.write_raw_model(str(d / "final.raw"),
                        numpy_state(TdnnChain(cfg), rng), cfg)
    with TableWriter(f"ark:{d / 'wav.ark'}", holder="wav") as w:
        # 54 and 75 frames: a multiple of the ×3 subsampling, where the
        # original scorer emits every frame too
        for i, n in enumerate((9000, 12340)):
            t = np.arange(n) / 16000.0
            x = 2000 * np.sin(2 * np.pi * (150 + 80 * i) * t) \
                + 300 * rng.standard_normal(n)
            w[f"utt{i}"] = (x.astype(np.int16), 16000)
    return d


def _words(path):
    return dict(SequentialTableReader(f"ark,t:{path}", holder="text"))


def test_online2_tool_matches_the_jax_tool(files):
    d = files
    args = [str(d / "final.mdl"), str(d / "final.raw"), str(d / "HCLG.fst"),
            f"ark:{d / 'wav.ark'}"]
    assert online2.online2_wav_nnet3_latgen_faster(
        ["--device=cpu"] + args + [f"ark,t:{d / 'port.txt'}"]) == 0
    assert tools_bank7.online2_wav_nnet3_latgen_faster(
        args + [f"ark,t:{d / 'jax.txt'}"]) == 0
    got, want = _words(d / "port.txt"), _words(d / "jax.txt")
    assert sorted(got) == ["utt0", "utt1"]
    assert got == want
    assert any(got.values())                 # some words were decoded


def test_online2_usage_and_guards(files, capsys, monkeypatch):
    assert online2.online2_wav_nnet3_latgen_faster(["only.mdl"]) == 1
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if "--device" in ln]
    assert line and line[0].rstrip().endswith("default = cuda)")
    d = files
    args = [str(d / "final.mdl"), str(d / "final.raw"), str(d / "HCLG.fst"),
            f"ark:{d / 'wav.ark'}", f"ark,t:{d / 'x.txt'}"]
    (d / "not_an_extractor").write_bytes(b"text")
    assert online2.main(["--device=cpu", "--ivector-extractor="
                         f"{d / 'not_an_extractor'}"] + args) == 1
    assert "not binary kaldi" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert online2.main(args) == 1
    assert "no CUDA card" in capsys.readouterr().err
    assert "device" in inspect.signature(online2._load_tdnn).parameters
