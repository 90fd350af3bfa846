"""The monophone-loop tools of the port against the JAX package's:
gmm-init-mono, compile-train-graphs, align-equal-compiled,
gmm-acc-stats-ali, gmm-sum-accs, gmm-est, gmm-mixup and
gmm-align-compiled, through ``kaldi_tpu_torch.cli.tools.main``
(``--device=cpu`` where the tool computes with tensors) and
``kaldi_tpu.cli.tools.main`` on the same files: yes/no MFCC + Δ
features of 4 synthetic utterances, their transcripts and lexicon.

Host code gives equal outputs (models, graphs, alignments, summed
accumulators).  gmm-acc-stats-ali's accumulators are float32 device
sums in another order: rtol 1e-5, as tests/test_torch_gmm_train.py.
gmm-est's update is the same numpy on the same accumulators: 1e-12.
gmm-align-compiled aligns a batch where the original aligns one
utterance at a time: equal alignments.

The original's gmm-mixup and ``gmm-est --mix-up`` drop ``mixup``'s
result and write the model unmixed; the port's write the mixed-up
model (ported to intent).
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.pipelines import yesno as jyesno
from kaldi_tpu.pipelines.data import make_synthetic_dataset, yesno_lexicon
from kaldi_tpu_torch.am.serialize import read_mdl, write_topology
from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.cli.tools_extra import read_gmm_accs
from kaldi_tpu_torch.core import io as tio
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.fst.lang import Lang, Lexicon

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gmmtools")
    data = make_synthetic_dataset(yesno_lexicon(), num_utts=4, max_words=4,
                                  seed=1)
    feats = jyesno.make_feats(data)
    with TableWriter(f"ark:{d / 'feats.ark'}", holder="mat") as w:
        for u in data.utts:
            w[u] = np.asarray(feats[u], np.float32)
    with TableWriter(f"ark:{d / 'text.ark'}", holder="text") as w:
        for u in data.utts:
            w[u] = data.text[u]
    lex = yesno_lexicon()
    (d / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(p)}\n" for w, p in lex.entries))
    phones = Lang(Lexicon(list(lex.entries))).phone_list()
    with open(d / "topo", "wb") as f:
        tio.init_kaldi_output_stream(f)
        write_topology(f, HmmTopology.three_state(phones))
    # the flat start and the training graphs, from the JAX tools: every
    # later step starts both sides from the same files
    assert jtools.main(["gmm-init-mono", f"--train-feats=ark:{d}/feats.ark",
                        "--perturb-factor=0.01", str(d / "topo"), "39",
                        str(d / "0.mdl"), str(d / "tree")]) == 0
    assert jtools.main(["compile-train-graphs", str(d / "lexicon.txt"),
                        str(d / "0.mdl"), f"ark:{d}/text.ark",
                        f"ark:{d}/graphs.ark"]) == 0
    assert jtools.main(["align-equal-compiled", f"ark:{d}/graphs.ark",
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark"]) == 0
    return d


def _both(d, name, args, port_opts=()):
    """Run ``name`` on both sides; ``{out}`` in args → a per-side path."""
    outs = {}
    for side, main, extra in (("port", ttools.main, list(port_opts)),
                              ("jax", jtools.main, [])):
        out = str(d / f"{name}.{side}")
        assert main([name, *extra,
                     *[a.format(d=d, out=out) for a in args]]) == 0, side
        outs[side] = out
    return outs["port"], outs["jax"]


def _models_equal(a, b, rtol=0.0):
    (ta, aa), (tb, ab) = read_mdl(a, device="cpu"), read_mdl(b, device="cpu")
    np.testing.assert_array_equal(ta.tid_to_pdf_array, tb.tid_to_pdf_array)
    for name in ("weights", "means", "vars"):
        np.testing.assert_allclose(getattr(aa, name), getattr(ab, name),
                                   rtol=rtol, atol=rtol)


def test_gmm_init_mono_equals_jax(files):
    for opts in ([], [f"--train-feats=ark:{files}/feats.ark",
                      "--perturb-factor=0.01"]):
        port, jax = _both(files, "gmm-init-mono",
                          [*opts, "{d}/topo", "39", "{out}.mdl",
                           "{out}.tree"])
        _models_equal(port + ".mdl", jax + ".mdl")
        with open(port + ".tree", "rb") as f, open(jax + ".tree", "rb") as g:
            assert f.read() == g.read()


def test_compile_train_graphs_and_align_equal_equal_jax(files):
    port, jax = _both(files, "compile-train-graphs",
                      ["{d}/lexicon.txt", "{d}/0.mdl", "ark:{d}/text.ark",
                       "ark:{out}"])
    got = dict(SequentialTableReader(f"ark:{port}", holder="fst"))
    want = dict(SequentialTableReader(f"ark:{jax}", holder="fst"))
    assert sorted(got) == sorted(want) != []
    for k in got:
        assert [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
                for arcs in got[k].arcs] == \
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
             for arcs in want[k].arcs]
    port, jax = _both(files, "align-equal-compiled",
                      [f"ark:{port}", "ark:{d}/feats.ark", "ark:{out}"])
    got = dict(SequentialTableReader(f"ark:{port}", holder="ivec"))
    want = dict(SequentialTableReader(f"ark:{jax}", holder="ivec"))
    assert sorted(got) == sorted(want) != []
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_acc_stats_sum_and_est_match_jax(files):
    port, jax = _both(files, "gmm-acc-stats-ali",
                      ["{d}/0.mdl", "ark:{d}/feats.ark", "ark:{d}/ali.ark",
                       "{out}"], port_opts=["--device=cpu"])
    pa, ja = read_gmm_accs(port), read_gmm_accs(jax)
    for name in ("occ", "mean_acc", "var_acc"):
        want = getattr(ja, name)
        np.testing.assert_allclose(getattr(pa, name), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(pa.tot_like, ja.tot_like, rtol=1e-4)
    assert pa.tot_frames == ja.tot_frames > 0
    # from here on both sides read the JAX accumulators
    port, jax = _both(files, "gmm-sum-accs", ["{out}", jax, jax])
    ps, js = read_gmm_accs(port), read_gmm_accs(jax)
    np.testing.assert_array_equal(ps.var_acc, js.var_acc)
    np.testing.assert_array_equal(ps.occ, 2 * ja.occ)
    port, jax = _both(files, "gmm-est", ["{d}/0.mdl", jax, "{out}"])
    _models_equal(port, jax, rtol=1e-12)


@pytest.mark.parametrize("tool", ["gmm-mixup", "gmm-est"])
def test_mixup_writes_the_mixed_model(files, tool):
    """The original writes the model unmixed (it drops mixup's result);
    the port writes it with the Gaussians asked for."""
    d = files
    assert jtools.main(["gmm-acc-stats-ali", str(d / "0.mdl"),
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        str(d / "0.acc")]) == 0
    args = (["--mix-up=25", "{d}/0.mdl", "{out}"] if tool == "gmm-mixup"
            else ["--mix-up=25", "{d}/0.mdl", "{d}/0.acc", "{out}"])
    port, jax = _both(d, tool, args)
    _, jam = read_mdl(jax, device="cpu")
    _, pam = read_mdl(port, device="cpu")
    _, am0 = read_mdl(str(d / "0.mdl"), device="cpu")
    assert jam.num_gauss() == am0.num_gauss() == am0.num_pdfs
    assert pam.num_gauss() == 25


def test_gmm_align_compiled_equals_jax(files):
    d = files
    assert jtools.main(["gmm-acc-stats-ali", str(d / "0.mdl"),
                        f"ark:{d}/feats.ark", f"ark:{d}/ali.ark",
                        str(d / "a.acc")]) == 0
    assert jtools.main(["gmm-est", str(d / "0.mdl"), str(d / "a.acc"),
                        str(d / "1.mdl")]) == 0
    port, jax = _both(d, "gmm-align-compiled",
                      ["{d}/1.mdl", "ark:{d}/graphs.ark", "ark:{d}/feats.ark",
                       "ark:{out}"], port_opts=["--device=cpu"])
    got = dict(SequentialTableReader(f"ark:{port}", holder="ivec"))
    want = dict(SequentialTableReader(f"ark:{jax}", holder="ivec"))
    assert sorted(got) == sorted(want) != []
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
