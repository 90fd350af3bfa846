"""``BeamDecoder.decode_batch`` and ``decode_lattice_batch`` of the port
against the JAX decoder's on a padded ragged batch (CPU tensors): the
same (tids, olabels) and costs within 1e-3 per utterance, and raw
lattices with the same states, arcs, best path and determinized paths,
with the device β-prune on and off and with escalation firing (the raw
lattices of escalated utterances come from the escalated decoder).  Each
side decodes a graph built by its own package from the same seed."""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder import beam as jbeam
from kaldi_tpu.lattice.determinize import determinize_lattice as j_det
from kaldi_tpu.pipelines import largevocab as jlv
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.decoder import beam as tbeam
from kaldi_tpu_torch.lattice.determinize import determinize_lattice as t_det
from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    kw = dict(vocab_size=300, order=3, seed=11, closure=False,
              corpus_sentences=600)
    task = tlv.make_largevocab_task(**kw)
    jtask = jlv.make_largevocab_task(**kw)
    ev = tlv.sample_eval_set(task, 5, max_words=7, seed=3)
    rng = np.random.default_rng(77)
    lls = [tlv.synth_loglikes(task, ev[u], rng, noise=0.6)
           for u in sorted(ev)]
    lens = np.array([len(x) for x in lls], np.int64)
    # ragged rows padded to a multiple of 32 frames, junk in the padding
    T_pad = int(np.ceil(lens.max() / 32) * 32)
    X = rng.standard_normal((len(lls), T_pad, task.num_pdfs)).astype(
        np.float32)
    for b, x in enumerate(lls):
        X[b, :len(x)] = x
    assert len(set(lens.tolist())) == len(lens)
    return task, jtask, X, lens


def _decoders(task, jtask, **over):
    kw = dict(beam=13.0, max_active=7000, acoustic_scale=1.0,
              lattice_beam=5.0, arc_budget=512, token_capacity=256,
              arc_block=8, escalate_budget=2048, escalate_deficit=4.0,
              lattice_arcs_per_frame=512, record_capacity=16384)
    kw.update(over)
    tdec = tbeam.BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                             tbeam.BeamDecoderConfig(**kw), device="cpu")
    jdec = jbeam.BeamDecoder(jtask.graph.csr, jtask.tm.tid_to_pdf_array,
                             jbeam.BeamDecoderConfig(**kw))
    return tdec, jdec


@pytest.mark.parametrize("beta", [True, False])
def test_decode_batch_matches_jax(batch, beta):
    task, jtask, X, lens = batch
    tdec, jdec = _decoders(task, jtask, device_beta_prune=beta,
                           lattice_arcs_per_frame=0, escalate_budget=0)
    got = tdec.decode_batch(X, lens)
    want = jdec.decode_batch(X, lens)
    assert len(got) == len(want) == len(lens)
    for (gt, go, gc), (wt, wo, wc) in zip(got, want):
        assert gt == wt and go == wo
        assert abs(gc - wc) < 1e-3
    # the batch's rows are each the single-utterance decode
    for b, T in enumerate(lens):
        assert tdec.decode(X[b, :T])[:2] == got[b][:2]


def test_decode_batch_takes_a_tensor(batch):
    task, jtask, X, lens = batch
    tdec, _ = _decoders(task, jtask, lattice_arcs_per_frame=0,
                        escalate_budget=0)
    a = tdec.decode_batch(torch.from_numpy(X), torch.from_numpy(lens))
    b = tdec.decode_batch(X, lens)
    assert [x[:2] for x in a] == [x[:2] for x in b]


def _arc_multiset(lat):
    return sorted((a.ilabel, a.olabel, round(a.graph_cost, 3),
                   round(a.acoustic_cost, 3))
                  for s in range(lat.num_states) for a in lat.arcs[s])


@pytest.mark.parametrize("beta,arc_budget", [(True, 512), (False, 512),
                                             (True, 64)])
def test_decode_lattice_batch_matches_jax(batch, beta, arc_budget):
    """Raw lattices: the same state and arc counts, arcs (labels and
    weights to 1e-3), best path, and the same word paths once
    determinized; arc_budget 64 makes escalation fire."""
    task, jtask, X, lens = batch
    tdec, jdec = _decoders(task, jtask, device_beta_prune=beta,
                           arc_budget=arc_budget,
                           token_capacity=min(256, arc_budget))
    got = tdec.decode_lattice_batch(X, lens)
    want = jdec.decode_lattice_batch(X, lens)
    assert len(got) == len(want) == len(lens)
    for g, w in zip(got, want):
        assert g.num_states == w.num_states
        assert g.num_arcs == w.num_arcs
        assert _arc_multiset(g) == _arc_multiset(w)
        gw, gt, gc = g.best_path()
        ww, wt, wc = w.best_path()
        assert (gw, gt) == (ww, wt)
        assert abs(gc - wc) < 1e-3
        gd, wd = t_det(g), j_det(w)
        assert dict(gd.paths()).keys() == dict(wd.paths()).keys()
    if arc_budget == 64:
        hosts = tdec._decode_host(X, lens, lattice=True)
        assert any(tdec.needs_escalation(h) for h in hosts)


def test_decode_lattice_batch_needs_lattice_arcs(batch):
    task, jtask, X, lens = batch
    tdec, _ = _decoders(task, jtask, lattice_arcs_per_frame=0,
                        escalate_budget=0)
    with pytest.raises(KaldiError):
        tdec.decode_lattice_batch(X, lens)
