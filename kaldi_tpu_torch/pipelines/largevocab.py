"""Large-vocabulary synthetic decode task, decoded by the port.

Jax-free copy of kaldi_tpu/pipelines/largevocab.py's task builder
(``make_largevocab_task``, monophone or left-biphone), ``synth_loglikes``
and ``sample_eval_set``: the original module imports no JAX itself, but
its package does.  The builders produce the same task, graph and
utterances from the same seeds.  ``run``/``main`` decode an eval set
with lattices on one device and report WER and throughput.

Runnable:  python -m kaldi_tpu_torch.pipelines.largevocab --vocab=20000
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu_torch.am.topology import HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import MonophoneContextDependency
from kaldi_tpu_torch.core.logging import Timer, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.fst.arpa import ArpaModel, estimate_arpa
from kaldi_tpu_torch.fst.biglang import (BigGraph, build_big_graph, eps_close,
                                   make_symbol_tables)
from kaldi_tpu_torch.fst.fst import SymbolTable

log = get_logger(__name__)


@dataclasses.dataclass
class LargeVocabTask:
    entries: List[Tuple[str, List[str]]]
    arpa: ArpaModel
    words: SymbolTable
    phones: SymbolTable
    topo: HmmTopology
    tree: MonophoneContextDependency
    tm: TransitionModel
    graph: BigGraph
    texts: List[List[str]]          # training corpus (LM source)
    pron_of: Dict[str, List[str]]
    # per-phone (fwd_pdf, self_pdf) for utterance synthesis
    fwd_pdf: Dict[str, int] = None
    slf_pdf: Dict[str, int] = None

    @property
    def num_pdfs(self) -> int:
        return self.tree.num_pdfs

    def pdf_pair(self, left_id: int, phone_id: int) -> Tuple[int, int]:
        """(forward pdf, self-loop pdf) of a phone instance with the
        given LEFT phone id (0 = none) — context-aware for CD trees,
        left ignored for monophone."""
        st = self.topo.topology_for_phone(phone_id)[0]
        if self.tree.context_width == 1:
            window = [phone_id]
        else:
            window = [left_id, phone_id]
        return (self.tree.compute(window, st.forward_pdf_class),
                self.tree.compute(window, st.self_loop_pdf_class))


def make_largevocab_task(vocab_size: int = 20000,
                         num_phones: int = 40,
                         order: int = 3,
                         prune_count: int = 2,
                         corpus_sentences: int = 8000,
                         seed: int = 7,
                         closure: bool = True,
                         self_loop_scale: float = 1.0,
                         entries: Optional[List[Tuple[str, List[str]]]]
                         = None,
                         context: str = "mono") -> LargeVocabTask:
    """Synthesize lexicon + Zipfian Markov corpus + pruned n-gram LM,
    and build the decode graph (biglang direct construction).  Pass
    ``entries`` to supply a custom lexicon; phone names must be
    p00-style.

    ``context``: "mono" (default) or "biphone" — the latter builds a
    LEFT-BIPHONE (2,1) decision tree from synthetic context-shifted
    stats and dispatches the graph build through biglang's
    context-dependent construction."""
    timer = Timer()
    rng = np.random.default_rng(seed)
    if entries is None:
        phones = [f"p{i:02d}" for i in range(num_phones)]
        entries = []
        for i in range(vocab_size):
            L = int(rng.integers(3, 9))
            entries.append((f"w{i:05d}",
                            [phones[int(k)] for k in
                             rng.integers(0, num_phones, L)]))
    else:
        vocab_size = len(entries)
        phones = sorted({p for _, pron in entries for p in pron})
    entries = sorted(entries)
    ws = [w for w, _ in entries]
    zipf = 1.0 / np.arange(1, vocab_size + 1)
    zipf /= zipf.sum()
    texts = [[ws[int(k)] for k in
              rng.choice(vocab_size, size=int(rng.integers(4, 15)), p=zipf)]
             for _ in range(corpus_sentences)]
    arpa = estimate_arpa(texts, order=order, prune_count=prune_count,
                         vocab=ws)
    words, ptab = make_symbol_tables(entries)
    pl = [ptab[p] for p in ["SIL"] + phones]
    topo = HmmTopology.chain(pl)
    if context == "biphone":
        # (2,1) tree over synthetic context-shifted stats: per-window
        # means offset by the left phone so the tree genuinely splits
        # on context (the build_tree.sh left-biphone chain contract)
        from kaldi_tpu_torch.am.tree import GaussStats, build_tree
        from kaldi_tpu_torch.pipelines.tri import cluster_phone_questions
        srng = np.random.default_rng(seed + 31)
        stats = {}
        for pid in pl:
            for left in [0] + pl:
                for pc in range(2):
                    g = GaussStats(3)
                    mean = np.array([pid, 0.37 * left, 0.8 * pc])
                    for _ in range(4):
                        g.accumulate(mean + 0.05 * srng.standard_normal(3))
                    stats[((left, pid), pc)] = g
        questions = cluster_phone_questions(stats, central_position=1)
        tree = build_tree(stats, questions, 2, 1,
                          max_leaves=4 * len(pl))
    elif context == "mono":
        tree = MonophoneContextDependency(pl, topo)
    else:
        raise ValueError(f"context must be mono|biphone, got {context}")
    tm = TransitionModel(topo, tree)
    graph = build_big_graph(entries, arpa, tm, words, ptab,
                            self_loop_scale=self_loop_scale)
    if closure and context == "mono":
        # ε-transitive-closure keeps the sweep count at 1 for decoders
        # that run ε sweeps; CD graphs skip it (their ε paths can carry
        # several word olabels — the BeamDecoder's eps_precompose
        # handles those via olabel sequences at construction)
        graph.csr = eps_close(graph.csr)
    fwd_pdf, slf_pdf = {}, {}
    for p in phones + ["SIL"]:
        pid = ptab[p]
        st = topo.topology_for_phone(pid)[0]
        w0 = [pid] if tree.context_width == 1 else [0, pid]
        fwd_pdf[p] = tree.compute(w0, st.forward_pdf_class)
        slf_pdf[p] = tree.compute(w0, st.self_loop_pdf_class)
    log.info("largevocab task: %d words, graph %d states %d+%d arcs "
             "(%.1fs)", vocab_size, graph.csr.num_states,
             graph.csr.num_emitting_arcs, graph.csr.num_eps_arcs,
             timer.elapsed())
    return LargeVocabTask(entries=entries, arpa=arpa, words=words,
                          phones=ptab, topo=topo, tree=tree, tm=tm,
                          graph=graph, texts=texts,
                          pron_of=dict(entries),
                          fwd_pdf=fwd_pdf, slf_pdf=slf_pdf)


def synth_alignment(task: LargeVocabTask, sent: Sequence[str],
                    rng: np.random.Generator, sil_prob: float = 0.3,
                    frames_per_phone: Tuple[int, int] = (2, 5)
                    ) -> List[int]:
    """The pdf of every frame of a sentence: optional silences between
    words, each phone ``frames_per_phone`` frames long."""
    pdfs: List[int] = []
    prev = [0]          # left-phone id carried across words/silences

    def emit_phone(p):
        dur = int(rng.integers(*frames_per_phone))
        pid = task.phones[p]
        fwd, slf = task.pdf_pair(prev[0], pid)
        pdfs.append(fwd)
        pdfs.extend([slf] * (dur - 1))
        prev[0] = pid

    if rng.random() < sil_prob:
        emit_phone("SIL")
    for w in sent:
        for p in task.pron_of[w]:
            emit_phone(p)
        if rng.random() < sil_prob:
            emit_phone("SIL")
    return pdfs


def synth_loglikes(task: LargeVocabTask, sent: Sequence[str],
                   rng: np.random.Generator,
                   noise: float = 0.5,
                   peak: float = 6.0,
                   sil_prob: float = 0.3,
                   frames_per_phone: Tuple[int, int] = (2, 5)
                   ) -> np.ndarray:
    """(T, P) synthetic acoustic log-likelihoods for a sentence, peaked
    on the true pdf sequence, with Gaussian noise on top (the WER
    knob)."""
    pdfs = synth_alignment(task, sent, rng, sil_prob, frames_per_phone)
    T = len(pdfs)
    P = task.num_pdfs
    ll = np.full((T, P), -peak, np.float32)
    ll[np.arange(T), pdfs] = 0.0
    ll += noise * rng.standard_normal((T, P)).astype(np.float32)
    return ll


def sample_eval_set(task: LargeVocabTask, n_utts: int,
                    max_words: int = 8, seed: int = 1234
                    ) -> Dict[str, List[str]]:
    """Sentences from the LM's own training distribution — utt_id →
    word list."""
    rng = np.random.default_rng(seed)
    ws = [w for w, _ in task.entries]
    V = len(ws)
    zipf = 1.0 / np.arange(1, V + 1)
    zipf /= zipf.sum()
    out = {}
    for i in range(n_utts):
        n = int(rng.integers(2, max_words + 1))
        out[f"utt{i:04d}"] = [ws[int(k)] for k in
                              rng.choice(V, size=n, p=zipf)]
    return out


def run(vocab: int = 20000, n_utts: int = 32, noise: float = 0.5,
        beam: float = 13.0, max_active: int = 7000,
        lattice_beam: float = 7.0, batch: int = 8,
        lattice_arcs: int = 8192, seed: int = 7,
        context: str = "mono", device: str = "cuda"):
    """Build the task, decode an eval set to determinized lattices on
    ``device``, report WER and audio-seconds per second (decoded frames
    are ×3-subsampled chain frames, 30 ms each)."""
    import torch

    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.pipelines.score import compute_wer

    task = make_largevocab_task(vocab_size=vocab, seed=seed,
                                context=context)
    eval_set = sample_eval_set(task, n_utts)
    rng = np.random.default_rng(seed + 999)
    lls = {u: synth_loglikes(task, s, rng, noise=noise)
           for u, s in eval_set.items()}
    T_pad = max(x.shape[0] for x in lls.values())
    T_pad = int(np.ceil(T_pad / 64) * 64)
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                      BeamDecoderConfig(beam=beam, max_active=max_active,
                                        acoustic_scale=1.0,
                                        lattice_beam=lattice_beam,
                                        lattice_arcs_per_frame=lattice_arcs),
                      device=device)
    utts = sorted(lls)
    hyps = {}
    # warmup outside the timed region (first CUDA calls, allocator)
    warm = utts[:batch]
    Xw = np.zeros((len(warm), T_pad, task.num_pdfs), np.float32)
    lw = np.ones(len(warm), np.int64) * min(64, T_pad)
    dec.decode_compact_batch(Xw, lw)
    if dec.device.type == "cuda":
        torch.cuda.synchronize(dec.device)
    timer = Timer()
    audio_s = 0.0
    for i in range(0, len(utts), batch):
        chunk = utts[i:i + batch]
        X = np.zeros((len(chunk), T_pad, task.num_pdfs), np.float32)
        lens = np.zeros(len(chunk), np.int64)
        for b, u in enumerate(chunk):
            X[b, :lls[u].shape[0]] = lls[u]
            lens[b] = lls[u].shape[0]
        for u, lat in zip(chunk, dec.decode_compact_batch(X, lens)):
            hyps[u] = [task.words.find(o) for o in lat.best_path()[0]]
        audio_s += lens.sum() * 0.03
    dt = timer.elapsed()
    wer = compute_wer(eval_set, hyps)
    log.info("largevocab decode on %s: %s | %.1f audio-s in %.1fs = "
             "%.1f audio-s/s", device, wer, audio_s, dt, audio_s / dt)
    return wer, audio_s / dt


def main(argv=None):
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.pipelines.largevocab")
    po.register("vocab", int, 20000, "vocabulary size")
    po.register("num-utts", int, 32, "eval utterances")
    po.register("noise", float, 0.5, "acoustic noise level (WER knob)")
    po.register("beam", float, 13.0, "decode beam")
    po.register("max-active", int, 7000, "max active tokens")
    po.register("context", str, "mono",
                "acoustic context: mono | biphone (CD graph)")
    po.register("device", str, "cuda", "torch device to decode on")
    po.read(argv)
    wer, tput = run(vocab=po["vocab"], n_utts=po["num-utts"],
                    noise=po["noise"], beam=po["beam"],
                    max_active=po["max-active"], context=po["context"],
                    device=po["device"])
    print(wer)
    print(f"{tput:.1f} audio-s/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
