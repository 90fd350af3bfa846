"""The port stands alone and runs on the card unless asked otherwise.

* No module of ``kaldi_tpu_torch`` and not ``chip_smoke.py`` imports
  ``kaldi_tpu``, ``jax``, ``flax``, ``optax``, ``msgpack`` or
  ``tensorstore``, at top
  level or inside a function (an AST walk of every file; lm/, the
  msgpack codec and the copied lattice modules among them).
* The host modules the port copied from the JAX package name their
  original, and build the same graphs: the port's and the JAX package's
  builders give equal CSR arrays on seeded tasks.
* Every entry point defaults to ``device="cuda"``; without a card it
  raises before doing any work.
* The flagship runs its i-vector and RNNLM rungs by default, and the
  guards that raised on them are gone.
* am/ivector.py names its original on its first line, and each of its
  host copies (PLDA, clustering, silence weighting, the PLDA I/O) and
  ports names its original on the line above it; so does
  am/chain_supervision.py.
* ``ops/build.py`` rebuilds a kernel library when a shared header
  changes.
"""

import ast
import dataclasses
import glob
import inspect
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "kaldi_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
FORBIDDEN = ("kaldi_tpu", "jax", "flax", "optax", "msgpack", "tensorstore")


@pytest.mark.parametrize("path", ["kaldi_tpu_torch/lm/__init__.py",
                                  "kaldi_tpu_torch/lm/rnnlm.py",
                                  "kaldi_tpu_torch/core/msgpack.py",
                                  "kaldi_tpu_torch/lattice/ops.py",
                                  "kaldi_tpu_torch/lattice/word_align.py",
                                  "kaldi_tpu_torch/lattice/phone_align.py",
                                  "kaldi_tpu_torch/lattice/ctm.py",
                                  "kaldi_tpu_torch/parallel/tensor.py",
                                  "kaldi_tpu_torch/pipelines/checkpoint.py",
                                  "kaldi_tpu_torch/am/regtree.py",
                                  "kaldi_tpu_torch/cli/tools_bank7.py",
                                  "kaldi_tpu_torch/cli/tools_bank20.py",
                                  "kaldi_tpu_torch/cli/tools_bank31.py",
                                  "kaldi_tpu_torch/am/nnet2.py",
                                  "kaldi_tpu_torch/am/raw_nnet.py",
                                  "kaldi_tpu_torch/cli/tools_bank19.py",
                                  "kaldi_tpu_torch/cli/tools_bank25.py",
                                  "kaldi_tpu_torch/cli/tools_bank26.py",
                                  "kaldi_tpu_torch/tools/nnet2_check.py",
                                  "kaldi_tpu_torch/am/nnet1.py",
                                  "kaldi_tpu_torch/cli/tools_bank14.py",
                                  "kaldi_tpu_torch/cli/tools_bank18.py",
                                  "kaldi_tpu_torch/tools/nnet_loop_check.py",
                                  "kaldi_tpu_torch/pipelines/segment.py",
                                  "kaldi_tpu_torch/cli/tools_bank4.py",
                                  "kaldi_tpu_torch/tools/nnet2_train_check.py"])
def test_the_import_check_covers(path):
    """The RNNLM, its msgpack codec, the copied lattice modules, the
    tensor-parallel collectives, the orbax checkpoint reader, the
    regression tree, the serving tools' new banks, the nnet2 modules,
    tools and check script, and the nnet1 module, the cross-entropy
    loop's new banks and its check script, and the nnet2 training slice's
    segmenter, bank 4 and check script are among the files the import
    check walks."""
    assert path in PORT_FILES


# the one import of a FORBIDDEN package a port file may make: tensorstore,
# inside the function that reads the JAX package's orbax checkpoints (the
# card's machine has none)
FUNCTION_LOCAL = {"kaldi_tpu_torch/pipelines/checkpoint.py": {"tensorstore"}}


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_jax_or_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    local = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            local |= {id(n) for n in ast.walk(fn)}
    allowed = FUNCTION_LOCAL.get(path, set())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN
                and not (n.split(".")[0] in allowed and id(node) in local)]
    assert not bad, f"{path}: {bad}"


def test_checkpoint_reader_names_tensorstore_where_it_is_missing(
        monkeypatch, tmp_path):
    """Without tensorstore (the card's machine) reading an orbax
    checkpoint raises a KaldiError that names the package."""
    import sys
    from kaldi_tpu_torch.core.logging import KaldiError
    from kaldi_tpu_torch.pipelines.checkpoint import read_train_state
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(KaldiError, match="tensorstore"):
        read_train_state(str(tmp_path))


COPIED = {
    "core/logging.py", "core/options.py", "core/io.py", "core/table.py",
    "core/__init__.py", "fst/fst.py", "fst/csr.py", "fst/biglang.py",
    "fst/arpa.py", "fst/lang.py", "fst/hclg.py", "fst/ops.py",
    "fst/openfst_io.py", "fst/__init__.py", "lattice/lattice.py",
    "lattice/determinize.py", "lattice/io.py", "am/topology.py",
    "am/transitions.py", "am/tree.py", "native/__init__.py",
    "native/lattice_build.cpp", "native/lattice_det.cpp",
    "features/pitch.py", "features/resample.py", "pipelines/data.py",
    "fst/context.py", "lattice/functions.py", "decoder/training_graph.py",
    "lattice/rescore.py", "lattice/ops.py", "lattice/word_align.py",
    "lattice/phone_align.py", "lattice/ctm.py", "pipelines/datadir.py",
    "decoder/simple.py", "decoder/biglm.py", "fst/grammar.py", "kws.py",
    "pipelines/segment.py"}


@pytest.mark.parametrize("rel", sorted(COPIED))
def test_copied_module_names_its_original(rel):
    with open(os.path.join(REPO, "kaldi_tpu_torch", rel)) as f:
        first = f.readline()
    assert f"Copied from kaldi_tpu/{rel}" in first, first
    assert os.path.isfile(os.path.join(REPO, "kaldi_tpu", rel))


def _same_csr(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=field.name)
        else:
            assert x == y, field.name


@pytest.mark.parametrize("order,closure", [(2, True), (3, False)])
def test_copied_graph_builders_give_equal_csr(order, closure):
    """The guard on the copies: biglang + csr (make_largevocab_task) and
    lang + arpa + hclg + ops (mkgraph + pack_fst) give the JAX package's
    CSR arrays, field for field, on one seeded task each."""
    from kaldi_tpu.pipelines import largevocab as jlv
    from kaldi_tpu_torch.pipelines import largevocab as tlv
    kw = dict(vocab_size=120, order=order, seed=11, closure=closure,
              corpus_sentences=300)
    _same_csr(tlv.make_largevocab_task(**kw).graph.csr,
              jlv.make_largevocab_task(**kw).graph.csr)
    from test_torch_beam import JAX, PORT, yesno_graph
    topology = "three_state" if closure else "chain"
    graphs = [side[6].pack_fst(yesno_graph(side, topology)[2])
              for side in (PORT, JAX)]
    _same_csr(*graphs)


def _entry_points():
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder
    from kaldi_tpu_torch.decoder.beam import BeamDecoder
    from kaldi_tpu_torch.decoder.dense import DenseDecoder
    from kaldi_tpu_torch.features.batch import BatchedFrontend
    from kaldi_tpu_torch.features.compute import Fbank, Mfcc, Plp, \
        Spectrogram
    from kaldi_tpu_torch.ops.fbank import CudaFbank
    from kaldi_tpu_torch.ops.gmm import CudaGmm
    from kaldi_tpu_torch.pipelines.decode import decode_gmm, decode_gmm_lattice
    from kaldi_tpu_torch.ops.chain_den import CudaChainDen
    from kaldi_tpu_torch.pipelines.chain import ChainTrainer
    from kaldi_tpu_torch.decoder.align import DenseAligner
    from kaldi_tpu_torch.pipelines import mini, yesno
    from kaldi_tpu_torch.pipelines.mono import train_mono
    from kaldi_tpu_torch.pipelines.tri import train_tri
    from kaldi_tpu_torch.pipelines import flagship, hard
    from kaldi_tpu_torch.am import ivector
    from kaldi_tpu_torch.lm import rnnlm
    from kaldi_tpu_torch.am import xvector
    from kaldi_tpu_torch.pipelines.nnet import XentTrainer
    return dict(XentTrainer=XentTrainer,
                train_xvector=xvector.train_xvector,
                load_xvector_model=xvector.load_xvector_model,train_rnnlm=rnnlm.train_rnnlm, load_rnnlm=rnnlm.load_rnnlm,
                RnnLmScorer=rnnlm.RnnLmScorer,
                IvectorExtractor=ivector.IvectorExtractor,
                train_diag_ubm=ivector.train_diag_ubm,
                read_ivector_extractor=ivector.read_ivector_extractor,
                compute_vad_energy=ivector.compute_vad_energy,
                DenseAligner=DenseAligner, flat_start=AmDiagGmm.flat_start,
                decode_eval=hard.decode_eval, run_point=hard.run_point,
                run_sweep=hard.run_sweep, flagship_run=flagship.run,
                flagship_align=flagship._align,
                train_mono=train_mono, train_tri=train_tri,
                yesno_run=yesno.run, mini_run=mini.run,
                BeamDecoder=BeamDecoder, DenseDecoder=DenseDecoder,
                _LatgenDecoder=_LatgenDecoder, Fbank=Fbank, Mfcc=Mfcc,
                AmDiagGmm=AmDiagGmm, CudaGmm=CudaGmm, CudaFbank=CudaFbank,
                decode_gmm_lattice=decode_gmm_lattice, decode_gmm=decode_gmm,
                read_mdl=read_mdl, CudaChainDen=CudaChainDen,
                ChainTrainer=ChainTrainer, Spectrogram=Spectrogram, Plp=Plp,
                BatchedFrontend=BatchedFrontend)


ENTRY_POINTS = ["BeamDecoder", "DenseDecoder", "_LatgenDecoder", "Fbank",
                "Mfcc", "AmDiagGmm", "CudaGmm", "CudaFbank",
                "decode_gmm_lattice", "decode_gmm", "read_mdl",
                "CudaChainDen", "ChainTrainer", "Spectrogram", "Plp",
                "BatchedFrontend", "DenseAligner", "flat_start",
                "train_mono", "train_tri", "yesno_run", "mini_run",
                "decode_eval", "run_point", "run_sweep", "flagship_run",
                "flagship_align", "IvectorExtractor", "train_diag_ubm",
                "read_ivector_extractor", "compute_vad_energy",
                "train_rnnlm", "load_rnnlm", "RnnLmScorer", "XentTrainer",
                "train_xvector", "load_xvector_model"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_the_card(capsys):
    """Both CLIs print their options on a wrong argument count: the
    device option defaults to cuda."""
    from kaldi_tpu_torch.cli import latgen
    assert latgen.gmm_latgen_faster(["only.mdl"]) == 1
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if "--device" in ln]
    assert line and line[0].rstrip().endswith("default = cuda)")
    from kaldi_tpu_torch.pipelines import largevocab
    assert inspect.signature(largevocab.run).parameters[
        "device"].default == "cuda"


def test_without_a_card_construction_raises(monkeypatch):
    """With no card (as on this host, or forced), the default device
    stops every entry point at once with a clear error; nothing goes on
    on the CPU."""
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    from kaldi_tpu_torch.core.logging import KaldiError
    from kaldi_tpu_torch.am.xvector import XvectorConfig
    from kaldi_tpu_torch.lm.rnnlm import RnnLm, RnnLmConfig
    from test_torch_beam import PORT, yesno_graph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eps = _entry_points()
    lang, tm, HCLG = yesno_graph(PORT, "three_state")
    csr = PORT[6].pack_fst(HCLG)
    P, tid = tm.num_pdfs, tm.tid_to_pdf_array
    w, m, v = np.ones((P, 1)), np.zeros((P, 1, 3)), np.ones((P, 1, 3))
    calls = [lambda: eps["BeamDecoder"](csr, tid),
             lambda: eps["DenseDecoder"](HCLG, tid),
             lambda: eps["_LatgenDecoder"](HCLG, tid, 13.0, 6.0, 0.1),
             lambda: eps["Fbank"](), lambda: eps["Mfcc"](),
             lambda: eps["AmDiagGmm"](w, m, v),
             lambda: eps["CudaGmm"](np.zeros((P, 1), np.float32),
                                    m.astype(np.float32),
                                    v.astype(np.float32)),
             lambda: eps["CudaFbank"](),
             lambda: eps["decode_gmm_lattice"](
                 {}, eps["AmDiagGmm"](w, m, v, device="cpu"), tm, HCLG, lang),
             lambda: eps["decode_gmm"](
                 {}, eps["AmDiagGmm"](w, m, v, device="cpu"), tm, HCLG, lang),
             lambda: eps["CudaChainDen"](1, [0], [0], [0], [0.0], [0.0],
                                         [0.0], [0], [0]),
             lambda: eps["ChainTrainer"](TdnnConfig(num_pdfs=P), None),
             lambda: eps["Spectrogram"](), lambda: eps["Plp"](),
             lambda: eps["BatchedFrontend"](),
             lambda: eps["DenseAligner"](tid),
             lambda: eps["flat_start"](P, np.zeros(3), np.ones(3)),
             lambda: eps["decode_eval"](None, {}),
             lambda: eps["run_point"](None, {}, {}),
             lambda: eps["flagship_run"](),
             lambda: eps["IvectorExtractor"](np.zeros((2, 3)), np.ones((2, 3)),
                                             np.ones(2) / 2, 2),
             lambda: eps["train_diag_ubm"]([np.zeros((4, 3))], num_gauss=2),
             lambda: eps["read_ivector_extractor"]("never.read"),
             lambda: eps["compute_vad_energy"](np.zeros((4, 3))),
             lambda: eps["train_rnnlm"]([[3, 4]], RnnLmConfig(8, 4, 4)),
             lambda: eps["load_rnnlm"]("never.read"),
             lambda: eps["RnnLmScorer"](RnnLm(RnnLmConfig(8, 4, 4)),
                                        lang.words),
             lambda: eps["XentTrainer"](TdnnConfig(
                 num_pdfs=P, frame_subsampling_factor=1)),
             lambda: eps["train_xvector"]({"u": np.zeros((4, 3))},
                                          {"u": "s"}, XvectorConfig()),
             lambda: eps["load_xvector_model"]("never.read")]
    for call in calls:
        with pytest.raises(KaldiError, match="no CUDA card"):
            call()


# the tensor-computing tools of the tri3b stack, full GMMs, EBW, the nnet2
# trainers and the long-audio segmenter, with their positional argument
# counts
CARD_TOOLS = {"gmm-acc-mllt": 4, "gmm-est-fmllr": 4,
              "gmm-acc-stats-twofeats": 5, "gmm-acc-stats": 4,
              "gmm-compute-likes": 3, "gmm-adapt-map": 4,
              "fgmm-global-acc-stats": 3, "fgmm-global-get-frame-likes": 3,
              "fgmm-gselect": 3,
              # the nnet2 trainers and segment-long-utterances' VAD
              "nnet-train-simple": 4, "nnet-train-parallel": 3,
              "nnet-train-ensemble": 5, "nnet-combine-fast": 5,
              "nnet-combine": 5, "nnet-normalize-stddev": 3,
              "nnet-train-discriminative-simple": 3,
              "nnet-train-discriminative-parallel": 3,
              "segment-long-utterances": 2}


@pytest.mark.parametrize("name", sorted(CARD_TOOLS))
def test_tensor_tools_default_to_the_card(name, monkeypatch):
    """Without ``--device`` the tool asks for the card, and without a card
    it raises before reading its inputs; nothing falls back to the
    CPU."""
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.core.logging import KaldiError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        TOOLS[name]([f"never.read.{i}" for i in range(CARD_TOOLS[name])])


def test_full_gmm_and_ladder_default_to_the_card(monkeypatch):
    from kaldi_tpu_torch.am.full_gmm import FullGmm
    from kaldi_tpu_torch.core.logging import KaldiError
    from kaldi_tpu_torch.pipelines import ladder, mini
    for fn in (FullGmm.__init__, FullGmm.from_diag, ladder.chain_stage,
               ladder.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        FullGmm(np.ones(1), np.zeros((1, 2)), np.ones((1, 2, 2)) * np.eye(2))
    for main in (ladder.main, mini.main):
        with pytest.raises(KaldiError, match="no CUDA card"):
            main(["--num-utts=4"])


def test_flagship_runs_the_rnnlm_rung_by_default():
    """``with_rnnlm`` defaults to True, as in the original, and the guard
    that raised on it (``RNNLM_ITEM``) is gone."""
    from kaldi_tpu_torch.pipelines import flagship
    assert inspect.signature(flagship.run).parameters[
        "with_rnnlm"].default is True
    assert not hasattr(flagship, "RNNLM_ITEM")


def test_flagship_runs_the_ivector_rung_by_default():
    """``with_ivector`` defaults to True, as in the original, and the
    guard that raised on it is gone."""
    from kaldi_tpu_torch.pipelines import flagship
    assert inspect.signature(flagship.run).parameters[
        "with_ivector"].default is True
    assert not hasattr(flagship, "IVECTOR_ITEM")


IVECTOR_COPIES = ["VadEnergyOptions", "OnlineSilenceWeighting", "Plda",
                  "agglomerative_cluster", "plda_score_matrix", "diarize",
                  "write_plda", "read_plda"]
IVECTOR_PORTS = ["compute_vad_energy", "IvectorExtractor", "train_diag_ubm",
                 "online_ivectors", "OnlineIvectorEstimator",
                 "write_ivector_extractor", "read_ivector_extractor"]


@pytest.mark.parametrize("name", IVECTOR_COPIES + IVECTOR_PORTS)
def test_ivector_module_names_its_originals(name):
    """am/ivector.py's first line names kaldi_tpu/am/ivector.py; each
    host copy's line above it says "Copied from" its original, each
    port's "Port of" it, and the original exists there."""
    path = os.path.join(REPO, "kaldi_tpu_torch", "am", "ivector.py")
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    assert "kaldi_tpu/am/ivector.py" in lines[0]
    node = next(n for n in ast.parse(src).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and n.name == name)
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    above = lines[first - 2]
    kind = "Copied from" if name in IVECTOR_COPIES else "Port of"
    assert above.startswith(f"# {kind} kaldi_tpu/am/ivector.py {name}"), \
        above
    with open(os.path.join(REPO, "kaldi_tpu", "am", "ivector.py")) as f:
        assert any(n.name == name for n in ast.parse(f.read()).body
                   if isinstance(n, (ast.FunctionDef, ast.ClassDef)))


SUP_COPIES = ["SupervisionFsa", "supervision_from_phone_runs",
              "supervision_from_text", "supervision_from_lattice",
              "chunk_supervision", "add_normalization_weights",
              "pack_supervisions", "make_chain_egs_from_lattices",
              "make_chain_egs_e2e"]
SUP_PORTS = ["_batched_segment_logsumexp", "numerator_fsa_logprob"]


@pytest.mark.parametrize("name", SUP_COPIES + SUP_PORTS)
def test_chain_supervision_names_its_originals(name):
    """am/chain_supervision.py's first line names its original; each host
    copy's line above it says "Copied from" it, each port "Port of" it,
    and the original exists there."""
    rel = os.path.join("am", "chain_supervision.py")
    with open(os.path.join(REPO, "kaldi_tpu_torch", rel)) as f:
        src = f.read()
    lines = src.splitlines()
    assert "kaldi_tpu/am/chain_supervision.py" in lines[0]
    node = next(n for n in ast.parse(src).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and n.name == name)
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    kind = "Copied from" if name in SUP_COPIES else "Port of"
    assert lines[first - 2].startswith(
        f"# {kind} kaldi_tpu/am/chain_supervision.py {name}"), \
        lines[first - 2]
    with open(os.path.join(REPO, "kaldi_tpu", rel)) as f:
        assert any(n.name == name for n in ast.parse(f.read()).body
                   if isinstance(n, (ast.FunctionDef, ast.ClassDef)))


def test_flagship_and_hard_mains_default_to_the_card(monkeypatch):
    """The flagship's and the hard corpus's mains hand their pipeline
    device "cuda" unless told otherwise."""
    from kaldi_tpu_torch.pipelines import flagship, hard
    seen = []

    def fake(*args, device=None, **kw):
        seen.append(device)
        raise SystemExit(0)

    monkeypatch.setattr(flagship, "run", fake)
    monkeypatch.setattr(hard, "run_sweep", fake)
    monkeypatch.setattr(hard, "run_point", fake)
    monkeypatch.setattr(hard, "make_hard_task", lambda **kw: None)
    monkeypatch.setattr(hard, "synth_eval", lambda *a, **kw: ({}, {}))
    for main, argv in ((flagship.main, []), (hard.main, []),
                       (hard.main, ["--sweep=false"]),
                       (flagship.main, ["--device=cpu"])):
        with pytest.raises(SystemExit):
            main(argv)
    assert seen == ["cuda", "cuda", "cuda", "cpu"]


def test_build_counts_headers_in_its_mtime_check(tmp_path, monkeypatch):
    """A library builds once, is reused while it is newer than its
    sources and csrc/*.cuh, and rebuilds when a header changes."""
    from kaldi_tpu_torch.ops import build
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "shared.cuh").write_text("// header\n")
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho x >> %s\nwhile [ $# -gt 0 ]; do "
                    "if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; "
                    "done\n" % log)
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "_LIBS", {})

    def builds():
        build._LIBS.clear()
        build.load_library("kt_probe", ("k.cu",))
        return len(log.read_text().split()) if log.exists() else 0

    assert builds() == 1
    assert builds() == 1                    # up to date: no rebuild
    so = out / "libkt_probe.so"
    later = os.path.getmtime(so) + 10
    os.utime(csrc / "shared.cuh", (later, later))
    assert builds() == 2                    # the header changed


def test_native_builds_under_a_per_process_name(tmp_path, monkeypatch):
    """The port's native library builds into build/kaldi_tpu_torch/ at
    the repository root, under a temporary name of its own process, so
    that test workers building at once do not race."""
    from kaldi_tpu_torch import native
    assert native._BUILD_DIR == os.path.join(REPO, "build",
                                             "kaldi_tpu_torch")
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd[cmd.index("-o") + 1])
        raise OSError("no compiler here")

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert native._build_and_load() is None      # the numpy fallback
    assert seen == [os.path.join(str(tmp_path),
                                 f"libkt_native.so.{os.getpid()}.tmp")]


@pytest.mark.parametrize("argv", [
    ["chip_smoke.py"],
    ["-m", "kaldi_tpu_torch.tools.profile_slice"],
    ["-m", "kaldi_tpu_torch.tools.profile_slice", "--den"],
    ["-m", "kaldi_tpu_torch.tools.profile_slice", "--features"],
    ["-m", "kaldi_tpu_torch.tools.flagship_spread"],
    ["kaldi_tpu_torch/tools/nnet2_check.py"],
    ["kaldi_tpu_torch/tools/nnet_loop_check.py"],
    ["kaldi_tpu_torch/tools/nnet2_train_check.py"]],
    ids=["chip_smoke", "profile_slice", "profile_slice-den",
         "profile_slice-features", "flagship_spread", "nnet2_check",
         "nnet_loop_check", "nnet2_train_check"])
def test_card_scripts_refuse_without_a_card(argv):
    """The scripts that measure on the card run their main, and without
    a card exit non-zero before printing any result."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, *argv], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr


PR14_PORTS = {"am/xconfig.py": ["am/xconfig.py"], "am/cnn.py": ["am/cnn.py"],
              "am/lstm.py": ["am/lstm.py"], "am/xvector.py": ["am/xvector.py"],
              "pipelines/nnet.py": ["pipelines/nnet.py"],
              "cli/tools_nnet.py": ["cli/tools_bank6.py", "cli/tools_bank9.py",
                                    "cli/tools_bank16.py",
                                    "cli/tools_bank29.py"]}


@pytest.mark.parametrize("rel", sorted(PR14_PORTS))
def test_xconfig_slice_modules_name_their_originals(rel):
    """The xconfig, LSTM, CNN, x-vector, xent and tool modules say on
    their first line which file of the JAX package they port, and that
    file exists; each copied or ported function or class above which a
    "Copied from" / "Port of" line stands names a function or class of
    that original."""
    with open(os.path.join(REPO, "kaldi_tpu_torch", rel)) as f:
        src = f.read()
    lines = src.splitlines()
    for orig in PR14_PORTS[rel]:
        assert orig.split("/")[-1] in lines[0], lines[0]
        assert os.path.isfile(os.path.join(REPO, "kaldi_tpu", orig))
    names = set()
    for orig in PR14_PORTS[rel]:
        with open(os.path.join(REPO, "kaldi_tpu", orig)) as f:
            for n in ast.walk(ast.parse(f.read())):
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                    names.add(n.name)
    marked = [ln.split()[-1].rstrip(".") for ln in lines
              if ln.startswith(("# Copied from kaldi_tpu/",
                                "# Port of kaldi_tpu/"))][1:]
    assert marked and all(n.split(".")[-1] in names for n in marked), marked


def test_chip_smoke_main_binds_the_device_kind_once():
    """The last line's ``kind`` is torch.cuda.get_device_name(0): no
    later assignment or loop in ``main`` rebinds the name."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    stores = [n.lineno for n in ast.walk(main)
              if isinstance(n, ast.Name) and n.id == "kind"
              and isinstance(n.ctx, ast.Store)]
    assert len(stores) == 1, stores


# the sequence-training modules and the tool banks of the host decoders,
# grammars, keyword search and sequence training: each names its original
# on line 1, and each marked function or class names one of the original
SEQ_PORTS = {"am/discriminative.py": "am/discriminative.py",
             "pipelines/discriminative.py": "pipelines/discriminative.py",
             **{f"cli/tools_bank{n}.py": f"cli/tools_bank{n}.py"
                for n in (4, 16, 17, 21, 23, 24, 27, 28, 29, 30)}}


@pytest.mark.parametrize("rel", sorted(SEQ_PORTS))
def test_sequence_slice_modules_name_their_originals(rel):
    orig = SEQ_PORTS[rel]
    with open(os.path.join(REPO, "kaldi_tpu_torch", rel)) as f:
        lines = f.read().splitlines()
    assert f"kaldi_tpu/{orig}" in lines[0], lines[0]
    with open(os.path.join(REPO, "kaldi_tpu", orig)) as f:
        names = {n.name for n in ast.walk(ast.parse(f.read()))
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    marked = [ln.split()[-1].rstrip(".") for ln in lines[1:]
              if ln.startswith((f"# Copied from kaldi_tpu/{orig} ",
                                f"# Port of kaldi_tpu/{orig} "))]
    assert marked and all(n in names for n in marked), marked


# the tools of the host decoders, grammars, sequence training and the
# cross-entropy recipes that compute with tensors, each with an argument
# list it never reads
SEQ_CARD_TOOLS = {
    "gmm-latgen-biglm-faster": ["--word-symbol-table=w"] + ["x"] * 6,
    "gmm-decode-biglm-faster": ["--word-symbol-table=w"] + ["x"] * 6,
    "gmm-latgen-simple": ["x"] * 4, "gmm-decode-simple": ["x"] * 4,
    "gmm-decode-faster": ["x"] * 4, "decode-faster": ["x"] * 3,
    "decode-faster-mapped": ["x"] * 4,
    "nnet3-latgen-grammar": ["x"] * 7,
    "online2-wav-nnet3-latgen-grammar": ["x"] * 7,
    "nnet3-discriminative-train": ["x"] * 3,
    "nnet3-discriminative-compute-objf": ["x"] * 2,
    "nnet3-discriminative-compute-from-egs": ["x"] * 3,
    # the cross-entropy recipes' tools: nnet3's loop and nnet1
    "nnet3-compute-prob": ["x"] * 2, "nnet3-align-compiled": ["x"] * 5,
    "nnet3-combine": ["x"] * 5, "align-mapped": ["x"] * 4,
    "nnet3-compute-from-egs": ["x"] * 3, "nnet-forward": ["x"] * 3,
    "rbm-train-cd1-frmshuff": ["x"] * 2, "nnet-train-frmshuff": ["x"] * 4,
    "nnet-train-perutt": ["x"] * 4, "nnet-train-mmi-sequential": ["x"] * 6,
    "nnet-train-mpe-sequential": ["x"] * 6,
    "nnet-train-multistream": ["x"] * 4,
    "nnet-train-multistream-perutt": ["x"] * 4,
    "align-compiled-mapped": ["x"] * 4}


@pytest.mark.parametrize("name", sorted(SEQ_CARD_TOOLS))
def test_sequence_slice_tools_default_to_the_card(name, monkeypatch):
    from kaldi_tpu_torch.cli import TOOLS
    from kaldi_tpu_torch.core.logging import KaldiError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        TOOLS[name]([a.replace("x", f"never.read.{i}") if a == "x" else a
                     for i, a in enumerate(SEQ_CARD_TOOLS[name])])


def test_sequence_entry_points_default_to_the_card(monkeypatch):
    """The sequence objectives run where their scores are; the trainer's
    tensors where the XentTrainer is, on the card by default."""
    import inspect
    from kaldi_tpu_torch.core.logging import KaldiError
    from kaldi_tpu_torch.pipelines.nnet import XentTrainer
    from kaldi_tpu_torch.am.tdnn import TdnnConfig
    assert inspect.signature(XentTrainer).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KaldiError, match="no CUDA card"):
        XentTrainer(TdnnConfig(frame_subsampling_factor=1))


def test_dteg_holder_still_raises_and_deg_reads(tmp_path):
    """``deg`` (DiscEg) and ``dteg`` (DenseEg) are ported: an archive of
    each round-trips; a DiscEg read as a DenseEg raises."""
    from kaldi_tpu_torch.core.logging import KaldiError
    from kaldi_tpu_torch.core.table import (SequentialTableReader,
                                            TableWriter)
    from kaldi_tpu_torch.pipelines.egs_io import DiscEg
    eg = DiscEg(feats=np.ones((2, 3), np.float32),
                num_ali=np.array([1, 2], np.int32),
                src=np.zeros((2, 1), np.int32),
                dst=np.zeros((2, 1), np.int32),
                pdf=np.array([[1], [2]], np.int32),
                w=np.zeros((2, 1), np.float32),
                mask=np.ones((2, 1), np.float32),
                final=np.zeros(1, np.float32))
    with TableWriter(f"ark:{tmp_path}/d.ark", holder="deg") as w:
        w["u"] = eg
    (key, back), = SequentialTableReader(f"ark:{tmp_path}/d.ark",
                                         holder="deg")
    assert key == "u"
    np.testing.assert_array_equal(back.pdf, eg.pdf)
    from kaldi_tpu_torch.pipelines.egs_io import DenseEg
    dense = DenseEg(feats=eg.feats, targets=np.full((2, 4), 0.5, np.float32))
    with TableWriter(f"ark:{tmp_path}/x.ark", holder="dteg") as w:
        w["a"] = dense
    (key, back), = SequentialTableReader(f"ark:{tmp_path}/x.ark",
                                         holder="dteg")
    assert key == "a"
    np.testing.assert_array_equal(back.targets, dense.targets)
    with pytest.raises(KaldiError):
        list(SequentialTableReader(f"ark:{tmp_path}/d.ark", holder="dteg"))
