"""The port's tree-building tools against the JAX package's, on the same
files: acc-tree-stats, sum-tree-stats, cluster-phones,
compile-questions, build-tree, gmm-init-model and convert-ali, through
``kaldi_tpu_torch.cli.tools.main`` and ``kaldi_tpu.cli.tools.main``
(mirroring tests/test_cli_bank5.py::test_tree_build_cli_pipeline and
tests/test_cli_bank9.py::test_convert_ali_identity).

Every one of these tools is host code copied from the original (tree
statistics and the tree in float64 numpy, gmm-init-model's single
Gaussians, the alignment remap): each output file must equal the JAX
tool's byte for byte.  Each step of the chain reads the JAX tool's
output of the step before, so only files cross.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.am.gmm import AmDiagGmm as JGmm
from kaldi_tpu.am.serialize import write_mdl as j_write_mdl
from kaldi_tpu.am.serialize import write_topology as j_write_topology
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.am.transitions import TransitionModel as JTM
from kaldi_tpu.am.tree import MonophoneContextDependency as JMono
from kaldi_tpu.cli import tools as jtools
from kaldi_tpu.core import io as jio
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)


def both(d, name, args, port_opts=()):
    """Run ``name`` on both sides; ``{out}`` in args → a per-side path,
    ``{d}`` → the directory.  → (port output, JAX output)."""
    outs = {}
    for side, main, extra in (("port", ttools.main, list(port_opts)),
                              ("jax", jtools.main, [])):
        out = str(d / f"{name}.{side}")
        assert main([name, *extra,
                     *[a.format(d=d, out=out) for a in args]]) == 0, side
        outs[side] = out
    return outs["port"], outs["jax"]


def same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """A 2-phone monophone model (the JAX package's), its topology, and
    features coloured by phone and state over valid alignments of 4
    utterances."""
    d = tmp_path_factory.mktemp("treetools")
    rng = np.random.default_rng(0)
    phones = [1, 2]
    topo = JTopo.three_state(phones)
    tree = JMono(phones, topo)
    tm = JTM(topo, tree)
    D, M = 3, 2
    am = JGmm(rng.dirichlet(np.ones(M), size=tree.num_pdfs),
              rng.standard_normal((tree.num_pdfs, M, D)),
              0.5 + rng.random((tree.num_pdfs, M, D)))
    j_write_mdl(str(d / "0.mdl"), tm, am)
    with jio.open_wxfilename(str(d / "topo")) as f:
        jio.init_kaldi_output_stream(f)
        j_write_topology(f, topo)

    fwd, slf = {}, {}
    for tid in range(1, tm.num_transition_ids + 1):
        key = (tm.transition_id_to_phone(tid),
               tm.transition_id_to_hmm_state(tid))
        (slf if tm.is_self_loop(tid) else fwd).setdefault(key, tid)

    def phone_tids(phone, loops):
        """A valid tid run through the 3 emitting states of ``phone``."""
        out = []
        for hmm_state in range(3):
            out.append(fwd[(phone, hmm_state)])
            out.extend([slf[(phone, hmm_state)]] * loops)
        return out

    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as wf, \
            TableWriter(f"ark:{d}/ali.ark", holder="ivec") as wa:
        for k, seq in enumerate([[1, 2], [2, 1], [1, 1], [2, 2, 1]]):
            tids = [t for p in seq for t in phone_tids(p, loops=k % 3)]
            # a mean for each (phone, HMM state): the tree splits both
            mu = [tm.transition_id_to_phone(t)
                  + 0.4 * tm.transition_id_to_hmm_state(t) for t in tids]
            wf[f"u{k}"] = np.stack([np.full(D, m, np.float32)
                                    + 0.1 * rng.standard_normal(D)
                                    for m in mu]).astype(np.float32)
            wa[f"u{k}"] = np.asarray(tids, np.int32)
    return d, tm


def test_tree_build_tools_equal_jax(mono):
    d, _ = mono
    steps = [
        ("acc-tree-stats", ["{d}/0.mdl", "ark:{d}/feats.ark",
                            "ark:{d}/ali.ark", "{out}"]),
        ("sum-tree-stats", ["{out}", "{d}/acc-tree-stats.jax",
                            "{d}/acc-tree-stats.jax"]),
        ("cluster-phones", ["{d}/sum-tree-stats.jax", "{out}"]),
        ("compile-questions", ["{d}/cluster-phones.jax", "{out}"]),
        ("build-tree", ["--max-leaves=10", "{d}/sum-tree-stats.jax",
                        "{d}/compile-questions.jax", "{out}"]),
        ("gmm-init-model", ["{d}/build-tree.jax", "{d}/sum-tree-stats.jax",
                            "{d}/topo", "{out}"]),
    ]
    for name, args in steps:
        port, jax = both(d, name, args)
        assert same_bytes(port, jax), name
    # the summed statistics are twice one file's, and the tree splits the
    # monophone leaves
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.tree import read_tree_stats
    one = read_tree_stats(str(d / "acc-tree-stats.port"))
    two = read_tree_stats(str(d / "sum-tree-stats.port"))
    assert set(one) == set(two) != set()
    k = next(iter(one))
    assert two[k].count == pytest.approx(2 * one[k].count)
    tm2, am2 = read_mdl(str(d / "gmm-init-model.port"), device="cpu")
    assert am2.num_pdfs >= mono[1].num_pdfs and am2.dim == 3


@pytest.mark.parametrize("to", ["0.mdl", "gmm-init-model.jax"])
def test_convert_ali_equal_jax(mono, to):
    """convert-ali onto the same model (the identity, with Kaldi's
    5-argument form) and onto the tree-built model."""
    d, _ = mono
    if to != "0.mdl" and not (d / to).exists():
        test_tree_build_tools_equal_jax(mono)
    port, jax = both(d, "convert-ali",
                     ["{d}/0.mdl", f"{{d}}/{to}", "unused-tree",
                      "ark:{d}/ali.ark", "ark:{out}"])
    assert same_bytes(port, jax)
    got = dict(SequentialTableReader(f"ark:{port}", holder="ivec"))
    want = dict(SequentialTableReader(f"ark:{d}/ali.ark", holder="ivec"))
    assert sorted(got) == sorted(want)
    for k in got:
        assert len(got[k]) == len(want[k])
        if to == "0.mdl":
            np.testing.assert_array_equal(got[k], want[k])
