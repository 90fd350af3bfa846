"""Hard-corpus lattice-QUALITY benchmark: large-vocabulary decoding
under real acoustic ambiguity, reporting 1-best WER, ORACLE (lattice)
WER, and lattice density across decoder budget operating points.

Port of kaldi_tpu/pipelines/hard.py.  The task is hard enough to be
falsifiable: a confusable lexicon (words come in families differing in
one phone, the minimal-pair structure real lexicons have), fewer
phones, and an acoustic noise level that puts 1-best WER in the
5–20 % band; ``run_sweep`` sweeps ``arc_budget`` / ``max_active`` and
scores each operating point the way the reference's lattice tooling
would:

  * %WER        — compute-wer on lattice best paths
  * oracle %WER — latbin/lattice-oracle.cc role: min edit distance
                  over ALL lattice paths (lattice/functions.py
                  oracle_errors)
  * density     — latbin/lattice-depth.cc role: arc-frames per
                  utterance frame

Acceptance: the default 4096 arc-budget point must lose <0.1 oracle
WER absolute vs the loosest budget on a task whose 1-best WER is
nonzero.

The decode runs on the port's ``BeamDecoder`` on ``device`` (default
the card; ``device="cpu"`` runs the same tensor ops on the host).  The
original's compile accounting (``compile_s``, ``esc_compile_wait_s``,
its jit cache and escalator prewarm) has no counterpart: the port
compiles nothing.  Its ``device_s`` timed the first batch again and
multiplied by the batch count; here, right after each batch's fetch,
its device work is captured once into a CUDA graph and the graph is run
once between CUDA events (``tools/timing.py`` ``graph_ms``: the card's
time with no host gaps; a batch's ~10⁵ launches overflow the launch
queue, so they cannot be queued whole behind a spin kernel as
``device_ms`` queues a kernel's calls), and the times are summed (on a
card only: a CPU run reports no device time).  The wall clock stops for
that measurement, whose seconds are reported as ``timing_s``; before it
stops, the card finishes the batches queued behind this one and the
lattice builds handed out so far finish, so that nothing of the decode
runs while it is stopped.  The batch's inputs are then freed.  The host
stages are timed as ``fetch_s`` (device → host copies, the wait for the
card included) and ``build_s`` (records → determinized lattice, summed
over the build threads).

Runnable:  python -m kaldi_tpu_torch.pipelines.hard [--sweep=true]
Emits one JSON line per operating point (HARDBENCH schema).
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
from kaldi_tpu_torch.device import resolve_device
from kaldi_tpu_torch.lattice.functions import lattice_depth, oracle_errors
from kaldi_tpu_torch.pipelines.largevocab import (LargeVocabTask,
                                                  make_largevocab_task,
                                                  sample_eval_set,
                                                  synth_loglikes)
from kaldi_tpu_torch.pipelines.score import compute_wer
from kaldi_tpu_torch.tools.timing import graph_ms

log = get_logger(__name__)


# Copied from kaldi_tpu/pipelines/hard.py confusable_entries.
def confusable_entries(vocab_size: int = 20000, num_phones: int = 24,
                       variants: int = 8, min_len: int = 3,
                       max_len: int = 7, seed: int = 11
                       ) -> List[Tuple[str, List[str]]]:
    """Lexicon of ``vocab_size`` words in families of ``variants``
    near-minimal pairs: each family shares a base pronunciation and
    every variant substitutes one phone, so family members differ in
    ≤2 positions — the lattice must keep whole confusion sets alive.
    A reduced phone inventory (24 vs the easy task's 40) raises the
    cross-family collision rate too."""
    rng = np.random.default_rng(seed)
    phones = [f"p{i:02d}" for i in range(num_phones)]
    entries: List[Tuple[str, List[str]]] = []
    wid = 0
    while wid < vocab_size:
        L = int(rng.integers(min_len, max_len + 1))
        base = rng.integers(0, num_phones, L)
        for v in range(variants):
            if wid >= vocab_size:
                break
            pron = base.copy()
            if v > 0:
                pron[int(rng.integers(0, L))] = int(
                    rng.integers(0, num_phones))
            entries.append((f"w{wid:05d}",
                            [phones[int(k)] for k in pron]))
            wid += 1
    return entries


# Copied from kaldi_tpu/pipelines/hard.py make_hard_task.
def make_hard_task(vocab: int = 20000, order: int = 3, seed: int = 7,
                   num_phones: int = 24, variants: int = 8,
                   **kw) -> LargeVocabTask:
    entries = confusable_entries(vocab, num_phones=num_phones,
                                 variants=variants, seed=seed + 4)
    return make_largevocab_task(vocab_size=vocab, order=order,
                                seed=seed, closure=False,
                                entries=entries, **kw)


# Copied from kaldi_tpu/pipelines/hard.py synth_eval.
def synth_eval(task: LargeVocabTask, n_utts: int, noise: float,
               peak: float, seed: int = 99, max_words: int = 12
               ) -> Tuple[Dict[str, List[str]], Dict[str, np.ndarray]]:
    eval_set = sample_eval_set(task, n_utts, max_words=max_words,
                               seed=seed)
    rng = np.random.default_rng(seed + 999)
    lls = {u: synth_loglikes(task, s, rng, noise=noise, peak=peak)
           for u, s in eval_set.items()}
    return eval_set, lls


# Copied from kaldi_tpu/pipelines/hard.py _batches.
def _batches(lls: Dict[str, np.ndarray], num_pdfs: int, B: int,
             bucket: int):
    """Length-sorted batches of ``B`` rows (the last one padded with
    empty rows), T padded UP to a multiple of ``bucket``."""
    utts = sorted(lls, key=lambda u: (len(lls[u]), u))
    out = []
    for i in range(0, len(utts), B):
        chunk = utts[i:i + B]
        T_pad = int(np.ceil(max(len(lls[u]) for u in chunk)
                            / bucket) * bucket)
        Xb = np.zeros((B, T_pad, num_pdfs), np.float32)
        lb = np.zeros(B, np.int32)
        for b, u in enumerate(chunk):
            Xb[b, :len(lls[u])] = lls[u]
            lb[b] = len(lls[u])
        out.append((chunk, Xb, lb))
    return out


# Port of kaldi_tpu/pipelines/hard.py decode_eval.
def decode_eval(task: LargeVocabTask, lls: Dict[str, np.ndarray],
                beam: float = 13.0, max_active: int = 7000,
                lattice_beam: float = 7.0, arc_budget: int = 4096,
                token_capacity: int = 4096, batch: int = 32,
                bucket: int = 96, record_capacity: int = 0,
                arc_block: int = 8, escalate_budget: int = 0,
                escalate_deficit: float = 4.0,
                pool: Optional[ThreadPoolExecutor] = None,
                device: torch.device | str = "cuda"
                ) -> Tuple[Dict[str, object], Dict[str, float]]:
    """Decode every utterance to a determinized CompactLattice at one
    operating point on ``device``; returns (utt → lattice, stats).

    ``escalate_budget`` > arc_budget enables the product escalation
    policy (BeamDecoderConfig.escalate_budget/escalate_deficit): an
    utterance whose accumulated beam deficit exceeds
    ``escalate_deficit`` is re-decoded at the wider budget, in batches
    of its own after the first sweep.  Throughput accounting includes
    the retries."""
    device = resolve_device(device)
    # decoder invariants: token_capacity ≤ arc_budget (a token expands
    # ≥1 arc) and token_capacity ≤ lattice_arcs_per_frame ≤ arc_budget
    token_capacity = min(token_capacity, arc_budget)
    cfg = BeamDecoderConfig(beam=beam, max_active=max_active,
                            acoustic_scale=1.0,
                            lattice_beam=lattice_beam,
                            arc_budget=arc_budget,
                            token_capacity=token_capacity,
                            arc_block=arc_block,
                            escalate_budget=escalate_budget,
                            escalate_deficit=escalate_deficit,
                            lattice_arcs_per_frame=min(4096, arc_budget),
                            # 0: records uncapped, a hard corpus never
                            # overflows at any lattice density
                            record_capacity=record_capacity)
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array, cfg,
                      device=device)
    batches = _batches(lls, task.num_pdfs, batch, bucket)
    own_pool = pool is None
    if own_pool:
        pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count()
                                                  or 4))
    on_card = device.type == "cuda"
    stats = {"shapes": len({Xb.shape for _, Xb, _ in batches}),
             "arcs_peak": 0, "heads_peak": 0, "dropped": 0,
             # frames where the arc budget imposed an effective beam
             # below lattice_beam lose lattice arcs (the oracle-WER
             # mechanism); min over the whole eval = worst case
             "min_eff_beam": float("inf"), "n_escalated": 0,
             "fetch_s": 0.0, "build_s": 0.0}
    if on_card:
        stats.update(device_s=0.0, timing_s=0.0)
    lats: Dict[str, object] = {}

    def build(decoder, host, T, ll):
        t = time.perf_counter()
        lat = decoder.build_compact_lattice(host, T, ll)
        return lat, time.perf_counter() - t

    def decode_all(decoder, batch_list):
        """One sweep over batches: queue every batch's device work,
        then fetch, flag and build.  Returns the utterances whose
        deficit trigger fired (first sweep only)."""
        outs = []
        for chunk, Xb, lb in batch_list:
            ll, nf = decoder._to_device(Xb, lb)
            outs.append((chunk, Xb, ll, nf, decoder._decode_batch(ll, nf)))
        futs, flagged = [], []
        for i in range(len(outs)):
            chunk, Xb, ll, nf, out = outs[i]
            outs[i] = None
            t = time.perf_counter()
            hosts = decoder._fetch_batch(out, lattice=True)
            stats["fetch_s"] += time.perf_counter() - t
            stats["arcs_peak"] = max(stats["arcs_peak"], max(
                int(h["max_arcs_demand"]) for h in hosts))
            stats["heads_peak"] = max(stats["heads_peak"], max(
                int(h["max_heads"]) for h in hosts))
            for b, (u, host) in enumerate(zip(chunk, hosts)):
                eff = float(host["min_eff_beam"])
                stats["min_eff_beam"] = min(stats["min_eff_beam"], eff)
                # the product trigger (BeamDecoder.needs_escalation);
                # the retries are batched below
                if decoder is dec and dec.needs_escalation(host):
                    flagged.append(u)
                    continue
                stats["dropped"] += int(host["dropped_arcs"])
                futs.append((u, pool.submit(build, decoder, host,
                                            int(len(lls[u])), Xb[b])))
            if on_card:
                torch.cuda.synchronize(device)
                wait([f for _, f in futs])
                t = time.perf_counter()
                stats["device_s"] += graph_ms(
                    lambda: decoder._decode_batch(ll, nf)) / 1e3
                stats["timing_s"] += time.perf_counter() - t
        for u, f in futs:
            lats[u], dt = f.result()
            stats["build_s"] += dt
        return flagged

    t0 = time.perf_counter()
    flagged = decode_all(dec, batches)
    if flagged:
        stats["n_escalated"] = len(flagged)
        decode_all(dec._escalator(),
                   _batches({u: lls[u] for u in flagged}, task.num_pdfs,
                            batch, bucket))
    stats["wall_s"] = time.perf_counter() - t0 - stats.get("timing_s", 0.0)
    stats["audio_s"] = sum(len(x) for x in lls.values()) * 0.03
    if on_card:
        stats["device_audio_s_per_s"] = (stats["audio_s"]
                                         / max(stats["device_s"], 1e-9))
    if own_pool:
        pool.shutdown()
    return lats, stats


# Copied from kaldi_tpu/pipelines/hard.py score_lattices.
def score_lattices(task: LargeVocabTask,
                   eval_set: Dict[str, List[str]],
                   lats: Dict[str, object]):
    """(wer_result, oracle%, density) over the eval set."""
    hyps, orc_err, orc_words = {}, 0, 0
    depth_num = depth_den = 0
    for u, lat in lats.items():
        hyps[u] = [task.words.find(o) for o in lat.best_path()[0]]
        ref_ids = [task.words[w] for w in eval_set[u]]
        orc_err += oracle_errors(lat, ref_ids)
        orc_words += len(ref_ids)
        dn, dd = lattice_depth(lat)
        depth_num += dn
        depth_den += dd
    wer = compute_wer(eval_set, hyps)
    oracle = 100.0 * orc_err / max(orc_words, 1)
    density = depth_num / max(depth_den, 1)
    return wer, oracle, density


# Port of kaldi_tpu/pipelines/hard.py run_point.
def run_point(task, eval_set, lls, pool=None, device="cuda", **knobs):
    lats, stats = decode_eval(task, lls, pool=pool, device=device,
                              **knobs)
    wer, oracle, density = score_lattices(task, eval_set, lats)
    rec = {
        "metric": "hard_corpus_lattice_quality",
        "arc_budget": knobs.get("arc_budget", 4096),
        "arc_block": knobs.get("arc_block", 8),
        "max_active": knobs.get("max_active", 7000),
        "wer": round(wer.wer, 2),
        "oracle_wer": round(oracle, 2),
        "density": round(density, 2),
        "audio_s_per_s": round(stats["audio_s"] / stats["wall_s"], 1),
        "dropped_arcs": stats["dropped"],
        "arcs_peak": stats["arcs_peak"],
        "heads_peak": stats["heads_peak"],
        "min_eff_beam": round(stats["min_eff_beam"], 2),
        "wall_s": round(stats["wall_s"], 2),
    }
    for k in ("device_s", "timing_s", "fetch_s", "build_s",
              "device_audio_s_per_s"):
        if k in stats:
            rec[k] = round(stats[k], 2)
    if knobs.get("escalate_budget"):
        rec["escalate_budget"] = knobs["escalate_budget"]
        rec["n_escalated"] = stats["n_escalated"]
    rec["device"] = (torch.cuda.get_device_name(torch.device(device))
                     if torch.device(device).type == "cuda" else "cpu")
    log.info("hard point %s", rec)
    return rec


# Port of kaldi_tpu/pipelines/hard.py run_sweep.
def run_sweep(vocab: int = 20000, n_utts: int = 1200,
              noise: float = 1.0, peak: float = 4.0,
              budgets=(2048, 4096, 12288), actives=(7000, 2000),
              max_words: int = 16, seed: int = 7, device="cuda"):
    """arc_budget ∈ budgets at max_active 7000, plus a max_active point
    at the default budget."""
    timer = Timer()
    task = make_hard_task(vocab=vocab, seed=seed)
    eval_set, lls = synth_eval(task, n_utts, noise=noise, peak=peak,
                               max_words=max_words)
    n_words = sum(len(s) for s in eval_set.values())
    log.info("hard corpus: %d utts / %d ref words / %.0f audio-s "
             "(graph %d states, %d arcs)", len(eval_set), n_words,
             sum(len(x) for x in lls.values()) * 0.03,
             task.graph.csr.num_states,
             task.graph.csr.num_emitting_arcs
             + task.graph.csr.num_eps_arcs)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4))
    results = []
    for ab in budgets:
        results.append(run_point(task, eval_set, lls, pool=pool,
                                 device=device, arc_budget=ab,
                                 max_active=7000))
    for ma in actives:
        if ma == 7000:
            continue                      # covered by the budget sweep
        results.append(run_point(task, eval_set, lls, pool=pool,
                                 device=device, arc_budget=4096,
                                 max_active=ma))
    pool.shutdown()
    log.info("hard sweep done in %.0fs", timer.elapsed())
    for r in results:
        print(json.dumps(r))
    return results


# Port of kaldi_tpu/pipelines/hard.py main.
def main(argv=None):
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.pipelines.hard")
    po.register("vocab", int, 20000, "vocabulary size")
    po.register("num-utts", int, 1000, "eval utterances")
    po.register("noise", float, 1.0, "acoustic noise (WER knob)")
    po.register("peak", float, 4.0, "true-pdf loglike margin")
    po.register("sweep", bool, True, "run the full budget sweep")
    po.register("device", str, "cuda", "torch device to decode on")
    po.read(argv)
    if po["sweep"]:
        run_sweep(vocab=po["vocab"], n_utts=po["num-utts"],
                  noise=po["noise"], peak=po["peak"], device=po["device"])
    else:
        task = make_hard_task(vocab=po["vocab"])
        eval_set, lls = synth_eval(task, po["num-utts"],
                                   noise=po["noise"], peak=po["peak"])
        print(json.dumps(run_point(task, eval_set, lls,
                                   device=po["device"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
