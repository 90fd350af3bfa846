"""The port's hard-corpus lattice-quality bench (pipelines/hard.py)
against the JAX package's, on the CPU: the confusable lexicon, the task
and its CSR graph, and the synthetic eval set equal the original's bit
for bit; ``decode_eval`` on a small hard task (300 words, 8 utterances),
with the product escalation firing and without, gives per-utterance
lattices with the same best path (costs within 1e-4), oracle errors and
depth, and the same budget diagnostics as the JAX ``decode_eval``; the
record of ``run_point`` keeps the HARDBENCH keys."""

import numpy as np
import pytest
import torch

from kaldi_tpu.lattice.functions import lattice_depth as j_depth
from kaldi_tpu.lattice.functions import oracle_errors as j_oracle
from kaldi_tpu.pipelines import hard as jhard
from kaldi_tpu_torch.lattice.functions import lattice_depth as t_depth
from kaldi_tpu_torch.lattice.functions import oracle_errors as t_oracle
from kaldi_tpu_torch.pipelines import hard as thard

torch.set_num_threads(1)

TASK = dict(vocab=300, seed=7, num_phones=16, corpus_sentences=1000)
EVAL = dict(n_utts=8, noise=1.1, peak=3.5, max_words=8)
# the knobs of each point: 512 arcs a frame makes the deficit trigger
# fire on this task, 4096 does not
POINTS = {"escalated": dict(arc_budget=512, max_active=512,
                            escalate_budget=4096),
          "plain": dict(arc_budget=4096, max_active=2000)}


@pytest.mark.parametrize("kw", [dict(vocab_size=160, num_phones=12,
                                     variants=8, seed=3),
                                dict(vocab_size=500, seed=11),
                                dict(vocab_size=77, num_phones=30,
                                     variants=5, min_len=2, max_len=9,
                                     seed=5)])
def test_confusable_entries_match_jax(kw):
    assert thard.confusable_entries(**kw) == jhard.confusable_entries(**kw)


@pytest.fixture(scope="module")
def tasks():
    task = thard.make_hard_task(**TASK)
    jtask = jhard.make_hard_task(**TASK)
    return task, jtask


def test_hard_task_matches_jax(tasks):
    task, jtask = tasks
    assert task.entries == jtask.entries
    assert task.texts == jtask.texts
    a, b = task.graph.csr, jtask.graph.csr
    assert a.num_states == b.num_states and a.start == b.start
    for f in ("e_offsets", "e_ilabel", "e_olabel", "e_weight",
              "e_nextstate", "n_offsets", "n_olabel",
              "n_weight", "n_nextstate", "final_costs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(task.tm.tid_to_pdf_array,
                                  jtask.tm.tid_to_pdf_array)


@pytest.fixture(scope="module")
def evals(tasks):
    task, jtask = tasks
    return thard.synth_eval(task, **EVAL), jhard.synth_eval(jtask, **EVAL)


def test_synth_eval_matches_jax_bit_for_bit(evals):
    (t_set, t_lls), (j_set, j_lls) = evals
    assert t_set == j_set
    assert sorted(t_lls) == sorted(j_lls)
    for u in j_lls:
        assert t_lls[u].dtype == j_lls[u].dtype
        np.testing.assert_array_equal(t_lls[u], j_lls[u])


def test_batches_match_jax(evals, tasks):
    (_, lls), _ = evals
    P = tasks[0].num_pdfs
    for (tc, tX, tl), (jc, jX, jl) in zip(thard._batches(lls, P, 3, 32),
                                          jhard._batches(lls, P, 3, 32)):
        assert tc == jc
        np.testing.assert_array_equal(tX, jX)
        np.testing.assert_array_equal(tl, jl)


@pytest.fixture(scope="module")
def decoded(tasks, evals):
    task, jtask = tasks
    (_, lls), _ = evals
    out = {}
    for name, knobs in POINTS.items():
        out[name] = (
            thard.decode_eval(task, lls, batch=4, bucket=32, device="cpu",
                              **knobs),
            jhard.decode_eval(jtask, lls, batch=4, bucket=32, **knobs))
    return out


@pytest.mark.parametrize("point", sorted(POINTS))
def test_decode_eval_matches_jax(decoded, evals, tasks, point):
    (t_lats, t_stats), (j_lats, j_stats) = decoded[point]
    (ev, _), _ = evals
    task = tasks[0]
    assert sorted(t_lats) == sorted(j_lats) == sorted(ev)
    for u in ev:
        tw, tt, tc = t_lats[u].best_path()
        jw, jt, jc = j_lats[u].best_path()
        assert (tw, tt) == (jw, jt), u
        assert abs(tc - jc) < 1e-4, u
        ref = [task.words[w] for w in ev[u]]
        assert t_oracle(t_lats[u], ref) == j_oracle(j_lats[u], ref)
        assert t_depth(t_lats[u]) == j_depth(j_lats[u])
    for k in ("n_escalated", "dropped", "arcs_peak", "heads_peak",
              "shapes"):
        assert t_stats[k] == j_stats[k], k
    assert abs(t_stats["min_eff_beam"] - j_stats["min_eff_beam"]) < 1e-6
    assert t_stats["audio_s"] == pytest.approx(j_stats["audio_s"])
    for k in ("wall_s", "fetch_s", "build_s"):
        assert t_stats[k] >= 0.0, k
    # a CPU run reports no device time
    assert "device_s" not in t_stats
    if point == "escalated":
        assert t_stats["n_escalated"] > 0
    else:
        assert t_stats["n_escalated"] == 0


def test_score_lattices_matches_jax(decoded, evals, tasks):
    (t_lats, _), (j_lats, _) = decoded["escalated"]
    (ev, _), _ = evals
    tw, to, td = thard.score_lattices(tasks[0], ev, t_lats)
    jw, jo, jd = jhard.score_lattices(tasks[1], ev, j_lats)
    assert tw.wer == jw.wer and to == jo and td == jd
    assert 0.0 < tw.wer and to <= tw.wer


def test_run_point_keeps_the_hardbench_keys(tasks, evals):
    task = tasks[0]
    (ev, lls), _ = evals
    few = sorted(lls)[:3]
    rec = thard.run_point(task, {u: ev[u] for u in few},
                          {u: lls[u] for u in few}, device="cpu", batch=4,
                          bucket=32, **POINTS["escalated"])
    for k in ("metric", "arc_budget", "arc_block", "max_active", "wer",
              "oracle_wer", "density", "audio_s_per_s", "dropped_arcs",
              "arcs_peak", "heads_peak", "min_eff_beam", "wall_s",
              "fetch_s", "escalate_budget", "n_escalated"):
        assert k in rec, k
    assert rec["metric"] == "hard_corpus_lattice_quality"
    assert rec["device"] == "cpu"
    for k in ("compile_s", "esc_compile_wait_s", "device_s",
              "device_audio_s_per_s"):
        assert k not in rec, k


def test_main_runs_one_point_on_cpu(capsys):
    assert thard.main(["--vocab=120", "--num-utts=2", "--sweep=false",
                       "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert '"metric": "hard_corpus_lattice_quality"' in out
