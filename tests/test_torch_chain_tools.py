"""The chain recipes and their tools in the port
(kaldi_tpu_torch/cli/tools_chain.py, pipelines/chain_cli_recipe.py,
pipelines/chain_recipe.py, pipelines/wav_recipe.py) on the CPU.

One module fixture runs the port's chain CLI recipe at a tiny size
(8 / 4 utterances, 2 mono iterations, 1 chain epoch, hidden 16): every
stage a tool of the port's ``TOOLS`` with files between.  Its work dir
then feeds each new tool and the JAX package's tool of the same name on
the same input files; their output files must be equal byte for byte
(nnet3-init: by layout and the weights' moments, since the original
draws them from jax.random).  Chain training on FSA-carrying egs runs
through nnet3-chain-train and nnet3-chain-compute-prob.
"""

import io
import math
import os

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import TOOLS as JTOOLS
from kaldi_tpu_torch.cli import TOOLS
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)

TINY = dict(num_utts=8, num_test=4, mono_iters=2, chain_epochs=1, hidden=16)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The port's chain CLI recipe at a tiny size on the CPU → (work dir,
    WER, per-stage seconds)."""
    from kaldi_tpu_torch.pipelines.chain_cli_recipe import run
    d = str(tmp_path_factory.mktemp("chain_cli"))
    stage_s = {}
    wer = run(d, device="cpu", stage_s=stage_s, **TINY)
    return d, wer, stage_s


def p(work, *parts):
    return os.path.join(work[0], *parts)


def _both(tmp_path, name, args_of, port_extra=()):
    """Run the port's tool and the JAX package's on the same inputs;
    ``args_of(out_dir)`` gives the arguments.  → (port dir, jax dir)."""
    out = {}
    for side, tools, extra in (("port", TOOLS, list(port_extra)),
                               ("jax", JTOOLS, [])):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        assert tools[name](extra + args_of(str(d))) == 0, side
        out[side] = d
    return out["port"], out["jax"]


def _same_files(a, b, *names):
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_cli_recipe_end_to_end(work):
    """Every stage's artifact on disk, a finite WER, each stage timed."""
    d, wer, stage_s = work
    for f in ("exp/mono/final.mdl", "exp/chain/0.mdl", "exp/chain/phones.ark",
              "exp/chain/egs.raw.ark", "exp/chain/egs.ark",
              "exp/chain/0.raw", "exp/chain/final.raw",
              "exp/chain/graph/G.fst", "exp/chain/graph/HCLG.fst",
              "exp/chain/decode_test/lat.1.ark",
              "exp/chain/decode_test/tra.txt", "data/train/feats.scp",
              "data/test/cmvn.scp"):
        assert os.path.exists(os.path.join(d, f)), f
    assert math.isfinite(wer.wer) and wer.ref_words > 0
    assert sorted(stage_s) == [f"stage {i}" for i in range(9)]


def test_chain_recipe_end_to_end(monkeypatch):
    """pipelines/chain_recipe.py at a tiny size: a finite WER with the
    built-in TDNN-F; --xconfig=default trains default_xconfig's model
    (am/xconfig.py) in its place and decodes with it."""
    from kaldi_tpu_torch.am.xconfig import XconfigChainModel
    from kaldi_tpu_torch.pipelines import chain_recipe
    wer = chain_recipe.run(num_utts=8, num_test=4, num_epochs=1, hidden=16,
                           device="cpu")
    assert math.isfinite(wer.wer) and wer.ref_words > 0
    seen = []
    real = chain_recipe.ChainTrainer

    def trainer(cfg, *a, **kw):
        seen.append(cfg)
        return real(cfg, *a, **kw)

    monkeypatch.setattr(chain_recipe, "ChainTrainer", trainer)
    assert chain_recipe.main(["--xconfig=default", "--device=cpu",
                              "--num-utts=8", "--num-epochs=1"]) in (0, 1)
    assert isinstance(seen[-1], XconfigChainModel)
    assert seen[-1].net.tdnnf5.linear.weight.shape == (32, 2 * 128)


@pytest.mark.parametrize("module", ["chain_cli_recipe", "chain_recipe",
                                    "wav_recipe"])
def test_recipes_default_to_the_card(module, tmp_path, monkeypatch):
    """Each recipe's main runs on the card unless told otherwise: without
    one it raises before writing anything."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"kaldi_tpu_torch.pipelines.{module}")
    argv = ([] if module == "chain_recipe"
            else [f"--work-dir={tmp_path}/w"])
    with pytest.raises(KaldiError, match="no CUDA card"):
        mod.main(argv)
    assert not os.path.exists(tmp_path / "w")


def test_gmm_copy_and_ali_to_phones(work, tmp_path):
    a, b = _both(tmp_path, "gmm-copy",
                 lambda o: [p(work, "exp/mono/final.mdl"), f"{o}/m.mdl"])
    _same_files(a, b, "m.mdl")
    ali = p(work, "exp/mono/ali.2.ark")
    a, b = _both(tmp_path, "ali-to-phones",
                 lambda o: [p(work, "exp/mono/final.mdl"), f"ark:{ali}",
                            f"ark:{o}/ph.ark"])
    _same_files(a, b, "ph.ark")


def test_compute_wer(work, capsys):
    tra = p(work, "exp/chain/decode_test/tra.txt")
    args = [f"ark,t:{p(work, 'data/test/text')}", f"ark,t:{tra}"]
    assert TOOLS["compute-wer"](args) == 0
    got = capsys.readouterr().out
    assert JTOOLS["compute-wer"](args) == 0
    assert got == capsys.readouterr().out
    assert got.strip() == str(work[1])


def test_arpa2fst_and_compile_graph(work, tmp_path):
    words = p(work, "lang/words.txt")
    a, b = _both(tmp_path, "arpa2fst",
                 lambda o: [f"--read-symbol-table={words}",
                            p(work, "lang/lm.arpa"), f"{o}/G.fst"])
    _same_files(a, b, "G.fst")
    a, b = _both(tmp_path, "compile-graph",
                 lambda o: ["--self-loop-scale=1.0",
                            p(work, "lang/lexicon.txt"),
                            p(work, "exp/chain/0.mdl"), f"{o}/../port/G.fst",
                            f"{o}/HCLG.fst"])
    _same_files(a, b, "HCLG.fst")


def test_chain_get_supervision(work, tmp_path):
    """Per-utterance FSAs from the recipe's alignments (read through the
    chain model's topology), equal in both packages and to the library's
    supervision_from_phone_runs."""
    from kaldi_tpu_torch.am.chain_supervision import \
        supervision_from_phone_runs
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.tools_chain import (_pdfs_for_factory,
                                                 _subsample_runs)
    from kaldi_tpu_torch.pipelines.chain import phone_alignment_runs
    mdl = p(work, "exp/mono/final.mdl")
    ali = p(work, "exp/mono/ali.2.ark")
    a, b = _both(tmp_path, "chain-get-supervision",
                 lambda o: [mdl, f"ark:{ali}", f"ark:{o}/sup.ark"])
    _same_files(a, b, "sup.ark")
    tm, _ = read_mdl(mdl, device="cpu")
    pf = _pdfs_for_factory(tm.tree, tm.topo)
    alis = dict(SequentialTableReader(f"ark:{ali}", holder="ivec"))
    n = 0
    for key, eg in SequentialTableReader(f"ark:{a}/sup.ark", holder="ceg"):
        runs = _subsample_runs(phone_alignment_runs(tm, alis[key].tolist()),
                               3)
        want = supervision_from_phone_runs(
            [runs], [0.0], lambda q: pf(q, True), lambda q: pf(q, False),
            sum(d for _, d in runs))
        for f in ("src", "dst", "entry_pdf", "self_pdf", "weight", "bt",
                  "final"):
            np.testing.assert_array_equal(getattr(eg.fsa, f),
                                          getattr(want, f), err_msg=f)
        assert eg.fsa.num_frames == want.num_frames
        n += 1
    assert n == len(alis)


def _num_frames_table(work, path):
    with TableWriter(f"ark:{path}", holder="ivec") as w:
        for k, m in SequentialTableReader(
                f"scp:{p(work, 'mfcc/final_train.scp')}", holder="mat"):
            w[k] = np.asarray([m.shape[0]], np.int32)


def test_chain_make_num_fst_e2e(work, tmp_path):
    nf = str(tmp_path / "nf.ark")
    _num_frames_table(work, nf)
    a, b = _both(tmp_path, "chain-make-num-fst-e2e",
                 lambda o: [p(work, "exp/chain/0.mdl"),
                            f"ark:{p(work, 'exp/chain/phones.ark')}",
                            f"ark:{nf}", f"ark:{o}/sup.ark"])
    _same_files(a, b, "sup.ark")


def test_nnet3_chain_get_egs_copy_shuffle(work, tmp_path):
    """nnet3-chain-get-egs on the recipe's files, then copy (--n=5) and
    shuffle (--srand=7): every archive equal between the packages, and
    the get-egs archive equal to make_chain_egs in process."""
    from kaldi_tpu_torch.am.chain import make_denominator_graph
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.pipelines.chain import (make_chain_egs,
                                                 phone_alignment_runs)
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    mono, chain = p(work, "exp/mono/final.mdl"), p(work, "exp/chain/0.mdl")
    ali = p(work, "exp/mono/ali.2.ark")
    feats = f"scp:{p(work, 'mfcc/final_train.scp')}"
    a, b = _both(tmp_path, "nnet3-chain-get-egs",
                 lambda o: ["--chunk-size=30", f"--ali-model={mono}", chain,
                            feats, f"ark:{ali}", f"ark:{o}/egs.ark"])
    _same_files(a, b, "egs.ark")
    for name, opt in (("nnet3-chain-copy-egs", "--n=5"),
                      ("nnet3-chain-shuffle-egs", "--srand=7")):
        c, d = _both(tmp_path, name,
                     lambda o: [opt, f"ark:{a}/egs.ark", f"ark:{o}/o.ark"])
        _same_files(c, d, "o.ark")
    tm, _ = read_mdl(chain, device="cpu")
    ali_tm, _ = read_mdl(mono, device="cpu")
    fe = dict(SequentialTableReader(feats, holder="mat"))
    runs = {k: phone_alignment_runs(ali_tm, v.tolist()) for k, v in
            SequentialTableReader(f"ark:{ali}", holder="ivec")}
    den = make_denominator_graph([[q for q, _ in runs[k]]
                                  for k in sorted(runs)], tm.tree, tm.topo,
                                 order=3)
    want = make_chain_egs(fe, runs, tm.tree, tm.topo, chunk_size=30,
                          subsample=3, den=den)
    got = read_egs_ark(f"ark:{a}/egs.ark")
    for f in ("feats", "pdf_ali", "mask", "num_segs", "init_w", "final_w"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.fixture(scope="module")
def e2e(work, tmp_path_factory):
    """nnet3-chain-e2e-get-egs of both packages on the recipe's features
    and ali-to-phones output → (port dir, jax dir)."""
    out = tmp_path_factory.mktemp("e2e")
    args = [p(work, "exp/chain/0.mdl"),
            f"scp:{p(work, 'mfcc/final_train.scp')}",
            f"ark:{p(work, 'exp/chain/phones.ark')}"]
    for side, tools in (("port", TOOLS), ("jax", JTOOLS)):
        (out / side).mkdir()
        assert tools["nnet3-chain-e2e-get-egs"](
            args + [f"ark:{out}/{side}/egs.ark",
                    f"{out}/{side}/den.fst"]) == 0
    return str(out / "port"), str(out / "jax")


def test_nnet3_chain_e2e_get_egs(e2e):
    """The FSA-carrying egs and the den graph, byte for byte; the egs
    read back with their supervision FSAs."""
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    _same_files(*e2e, "egs.ark", "den.fst")
    egs = read_egs_ark(f"ark:{e2e[0]}/egs.ark")
    assert egs.sup is not None and egs.entry_pdf is None
    assert (egs.sup["num_frames"] == egs.mask.sum(axis=1)).all()


def test_nnet3_chain_train_on_e2e_egs(work, e2e, tmp_path):
    """nnet3-chain-train on the FSA egs with free boundaries (tolerance =
    the longest subsampled length), 2 epochs; compute-prob before and
    after is finite, better after, and equals chain_objf(num_fsa=) in
    process."""
    from kaldi_tpu_torch.am.chain import (ChainTrainingOptions, chain_objf,
                                          make_denominator_graph)
    from kaldi_tpu_torch.am.chain_supervision import sup_to_device
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.chain import _read_phone_seqs
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    egs_spec = f"ark:{e2e[0]}/egs.ark"
    egs = read_egs_ark(egs_spec)
    tol = int(egs.mask.shape[1])
    mdl, phones = p(work, "exp/chain/0.mdl"), p(work, "exp/chain/phones.ark")
    common = ["--device=cpu", "--lm-order=2",
              f"--supervision-tolerance={tol}"]
    after = str(tmp_path / "1.raw")
    assert TOOLS["nnet3-chain-train"](
        common + ["--num-epochs=2", "--learning-rate=2e-3", mdl,
                  p(work, "exp/chain/0.raw"), f"ark:{phones}", egs_spec,
                  after]) == 0
    objf = {}
    for raw in (p(work, "exp/chain/0.raw"), after):
        out = io.StringIO()
        import contextlib
        with contextlib.redirect_stdout(out):
            assert TOOLS["nnet3-chain-compute-prob"](
                common + [mdl, raw, f"ark:{phones}", egs_spec]) == 0
        objf[raw] = float(out.getvalue().strip().splitlines()[-1])
    before, trained = objf[p(work, "exp/chain/0.raw")], objf[after]
    assert math.isfinite(before) and math.isfinite(trained)
    assert trained > before
    # the tool's number is chain_objf with the FSA numerator
    tm, _ = read_mdl(mdl, device="cpu")
    den = make_denominator_graph(_read_phone_seqs(f"ark:{phones}"), tm.tree,
                                 tm.topo, order=2)
    _, net = _load_tdnn(after, 3, "cpu")
    with torch.no_grad():
        loss, _ = chain_objf(
            den, net(torch.from_numpy(egs.feats)), None,
            torch.from_numpy(egs.mask), ChainTrainingOptions(),
            num_fsa=(sup_to_device(egs.sup, "cpu"), tol))
    assert -float(loss) == pytest.approx(trained, abs=1e-5)


def test_nnet3_init_layout_and_moments(tmp_path):
    """The port's nnet3-init and the JAX package's write the same
    components with the same shapes; the port's weights have the
    initializer's moments (variance 1/fan_in, a zero output layer,
    batch-norm statistics (0, 1)) and follow --srand."""
    from kaldi_tpu_torch.am.nnet3_io import read_nnet3_path
    opts = ["--feat-dim=30", "--num-pdfs=20", "--hidden-dim=64",
            "--bottleneck-dim=16", "--num-layers=3"]
    for side, tools in (("port", TOOLS), ("jax", JTOOLS)):
        for seed in (0, 1):
            assert tools["nnet3-init"](
                opts + [f"--srand={seed}",
                        str(tmp_path / f"{side}{seed}.raw")]) == 0
    mp, mj = (read_nnet3_path(str(tmp_path / f"{s}0.raw"))
              for s in ("port", "jax"))
    assert [c.name for c in mp.components] == [c.name for c in mj.components]
    assert [c.ctype for c in mp.components] == [c.ctype for c in mj.components]
    n_dense = 0
    other = read_nnet3_path(str(tmp_path / "port1.raw"))
    for cp, cj, co in zip(mp.components, mj.components, other.components):
        assert sorted(cp.fields) == sorted(cj.fields), cp.name
        for f, v in cp.fields.items():
            a = getattr(v, "array", None)
            if a is None:
                continue
            assert a.shape == cj.fields[f].array.shape, (cp.name, f)
            if (f in ("LinearParams", "Params")
                    and cp.name != "output.affine"):
                fan_in = a.shape[1]
                assert abs(a.std() * math.sqrt(fan_in) - 1.0) < 0.15, cp.name
                assert abs(a.mean()) < 0.1 and np.abs(a).max() * math.sqrt(
                    fan_in) <= 2.0 / 0.8796 + 1e-4
                assert not np.array_equal(a, co.fields[f].array)
                n_dense += 1
            elif cp.name == "output.affine" or f == "BiasParams":
                assert not a.any(), (cp.name, f)
            elif f in ("StatsMean", "StatsVar"):
                assert np.all(a == (0.0 if f == "StatsMean" else 1.0)), f
    assert n_dense == 2 + 2 * 3


def test_nnet3_latgen_faster(work, tmp_path):
    """The chain decode tool on the recipe's model, graph and test
    features, at lattice-beam 2: lattices and words equal to the JAX
    package's tool."""
    args = lambda o: ["--beam=16.0", "--lattice-beam=2.0",  # noqa: E731
                      "--acoustic-scale=1.0",
                      "--frame-subsampling-factor=3",
                      f"--word-symbol-table={p(work, 'lang/words.txt')}",
                      p(work, "exp/chain/0.mdl"),
                      p(work, "exp/chain/final.raw"),
                      p(work, "exp/chain/graph/HCLG.fst"),
                      f"scp:{p(work, 'mfcc/final_test.scp')}",
                      f"ark:{o}/lat.ark", f"ark,t:{o}/w.txt"]
    a, b = _both(tmp_path, "nnet3-latgen-faster", args,
                 port_extra=["--device=cpu"])
    _same_files(a, b, "w.txt")
    from kaldi_tpu_torch.core.table import SequentialTableReader as R
    got = dict(R(f"ark:{a}/lat.ark", holder="clat"))
    want = dict(R(f"ark:{b}/lat.ark", holder="clat"))
    assert sorted(got) == sorted(want)
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        assert gw == ww and gc == pytest.approx(wc, abs=1e-3), k


def _sausage(n: int = 6):
    """A raw lattice of n positions, each two word arcs with their own
    tid and costs: 2^n paths."""
    from kaldi_tpu_torch.lattice.lattice import Lattice, LatticeArc
    lat = Lattice()
    states = [lat.add_state() for _ in range(n + 1)]
    lat.start = states[0]
    for i in range(n):
        for k in range(2):
            lat.arcs[states[i]].append(LatticeArc(
                1 + k, 10 + 2 * i + k, 0.1 * k, 0.3 * (i + k),
                states[i + 1]))
    lat.set_final(states[n])
    return lat


def test_native_determinize_grows_its_capacity_to_max_states(monkeypatch):
    """The native pass retries on output-capacity overflow, past the
    original's three attempts, until its state capacity passes
    max_states: a lattice whose output overflows four times still comes
    out of the native pass (equal to the Python pass), and a blowup is
    raised there without the Python pass running."""
    from kaldi_tpu_torch import native
    from kaldi_tpu_torch.lattice import determinize as det
    lib = native.get_lib()
    if lib is None:
        pytest.skip("the port's native library did not build here")
    real = lib.kt_determinize_lattice
    calls = []

    def overflow_four_times(*a):
        calls.append(a[14])                      # cap_arcs of this try
        return -1 if len(calls) <= 4 else real(*a)

    monkeypatch.setattr(lib, "kt_determinize_lattice", overflow_four_times)
    lat = _sausage()
    got = det.determinize_lattice(lat)
    assert len(calls) == 5 and calls[-1] == 4 ** 4 * calls[0]
    want = det.determinize_lattice_py(lat)
    assert got.num_states == want.num_states
    assert sorted(got.best_path()[0]) == sorted(want.best_path()[0])
    assert got.best_path()[2] == pytest.approx(want.best_path()[2])

    def blowup(*a):
        return -3

    monkeypatch.setattr(lib, "kt_determinize_lattice", blowup)
    monkeypatch.setattr(det, "determinize_lattice_py", None)
    with pytest.raises(KaldiError, match="blowup"):
        det.determinize_lattice(lat)
