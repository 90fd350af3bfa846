"""Port of kaldi_tpu/cli/tools_bank3.py: compute-kaldi-pitch-feats,
process-kaldi-pitch-feats, compile-train-graphs, align-equal-compiled,
gmm-align-compiled, the posterior tools ali-to-post, weight-silence-post and lattice-to-post,
gmm-boost-silence, gmm-est-fmllr and the lattice tools lattice-1best,
lattice-oracle, lattice-add-penalty, lattice-lmrescore-const-arpa and
lattice-lmrescore-pruned.

Port of those tools of kaldi_tpu/cli/tools_bank3.py (parity targets
featbin/compute-kaldi-pitch-feats.cc, process-kaldi-pitch-feats.cc,
bin/compile-train-graphs.cc, align-equal-compiled.cc,
bin/ali-to-post.cc, weight-silence-post.cc,
gmmbin/gmm-align-compiled.cc, gmm-boost-silence.cc, gmm-est-fmllr.cc,
latbin/lattice-1best.cc, lattice-oracle.cc, lattice-add-penalty.cc,
lattice-to-post.cc, lattice-lmrescore-const-arpa.cc,
lattice-lmrescore-pruned.cc), registered in cli/tools.py's ``TOOLS``.
The lattice and posterior tools are the original's host code, copied,
but for lattice-lmrescore-const-arpa, ported to intent: it reads an
arpa-to-const-arpa file (the original reads only ARPA text, and fails
on that file) or ARPA text.
Training graphs, the equal alignment and gmm-boost-silence are host
code, as in the original; gmm-align-compiled runs the GMM kernel and the
aligner on ``--device`` (default cuda), ``ALIGN_BATCH`` utterances at a
time (the original aligns one at a time; the alignments are the same).
gmm-est-fmllr takes ``--device`` too, where the mixture posteriors of
its statistics run; it is ported to intent: the original hands a
(frames × pdfs) weight matrix to ``accumulate_fmllr_for_utt`` as if it
were a pdf alignment and fails, the port accumulates each frame's pdf
posteriors through ``accumulate_fmllr_from_post`` (Kaldi's
AccumulateFromPosteriors).
Pitch is host numpy (features/pitch.py), as in the original.  As there,
compute-kaldi-pitch-feats divides the int16-scale wave by 32768 and
compute-and-process-kaldi-pitch-feats (cli/tools_bank10.py) does not.
The NCCF's ballast is scaled by the signal's own mean square, and 32768
is a power of two, so the two give the same pitch all the same.
nnet3-average (nnet3bin/nnet3-average.cc) is the original's host code,
copied: the mean of each component field over the models, in float64.
nnet3-compute (nnet3bin/nnet3-compute.cc) runs the raw TDNN-F's forward
on ``--device`` (default cuda).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

# utterances gmm-align-compiled aligns in one batch
ALIGN_BATCH = 64


@tool("compute-kaldi-pitch-feats")
def compute_kaldi_pitch_feats(argv):
    from kaldi_tpu_torch.features.pitch import (PitchExtractionOptions,
                                                compute_kaldi_pitch)
    po = ParseOptions("compute-kaldi-pitch-feats [opts] <wav-rspec> "
                      "<feats-wspec>")
    po.register("sample-frequency", float, 16000.0, "expected sample rate")
    po.register("min-f0", float, 50.0, "min F0")
    po.register("max-f0", float, 400.0, "max F0")
    args = po.read(argv)
    with TableWriter(args[1], holder="mat") as w:
        for key, (wave, rate) in SequentialTableReader(args[0],
                                                       holder="wav"):
            opts = PitchExtractionOptions(samp_freq=float(rate),
                                          min_f0=po["min-f0"],
                                          max_f0=po["max-f0"])
            w[key] = compute_kaldi_pitch(np.asarray(wave, np.float32)
                                         / 32768.0, opts)
    return 0


@tool("process-kaldi-pitch-feats")
def process_kaldi_pitch_feats(argv):
    """(pov, pitch) → 3-dim (pov, normalized-log-pitch, delta-pitch)
    features (featbin/process-kaldi-pitch-feats.cc role)."""
    from kaldi_tpu_torch.features.pitch import process_pitch
    po = ParseOptions("process-kaldi-pitch-feats [opts] <pitch-rspec> "
                      "<feats-wspec>")
    po.register("pov-scale", float, 2.0, "scale on the POV feature")
    po.register("pitch-scale", float, 2.0, "scale on normalized log pitch")
    po.register("delta-pitch-scale", float, 10.0, "scale on delta pitch")
    args = po.read(argv)
    with TableWriter(args[1], holder="mat") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = process_pitch(np.asarray(mat),
                                   pov_scale=po["pov-scale"],
                                   pitch_scale=po["pitch-scale"],
                                   delta_scale=po["delta-pitch-scale"])
    return 0


# ---------------------------------------------------------------------------
# bin/gmmbin: training graphs + alignment
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank3.py _lang_from_lexicon.
def _lang_from_lexicon(path: str, sil_phone: str):
    from kaldi_tpu_torch.fst.lang import Lang, Lexicon
    entries: List[Tuple[str, List[str]]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                entries.append((parts[0], parts[1:]))
    return Lang(Lexicon(entries), sil_phone=sil_phone)


@tool("compile-train-graphs")
def compile_train_graphs(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.training_graph import TrainingGraphCompiler
    po = ParseOptions("compile-train-graphs [opts] <lexicon.txt> <model> "
                      "<text-rspec> <graphs-wspec>")
    po.register("transition-scale", float, 1.0, "transition scale")
    po.register("self-loop-scale", float, 0.1, "self-loop scale")
    po.register("sil-phone", str, "SIL", "optional-silence phone")
    args = po.read(argv)
    lang = _lang_from_lexicon(args[0], po["sil-phone"])
    tm, _ = read_mdl(args[1], device="cpu")
    compiler = TrainingGraphCompiler(lang, tm, po["transition-scale"],
                                     po["self-loop-scale"])
    n = 0
    with TableWriter(args[3], holder="fst") as w:
        for key, words in SequentialTableReader(args[2], holder="text"):
            w[key] = compiler.compile_text(list(words))
            n += 1
    log.info("compile-train-graphs: %d graphs", n)
    return 0


@tool("align-equal-compiled")
def align_equal_compiled(argv):
    from kaldi_tpu_torch.decoder.training_graph import equal_align
    po = ParseOptions("align-equal-compiled <graphs-rspec> <feats-rspec> "
                      "<ali-wspec>")
    args = po.read(argv)
    graphs = RandomAccessTableReader(args[0], holder="fst")
    with TableWriter(args[2], holder="ivec") as w:
        for key, m in SequentialTableReader(args[1], holder="mat"):
            if key not in graphs:
                log.warning("align-equal-compiled: no graph for %s", key)
                continue
            w[key] = np.asarray(
                equal_align(graphs[key], np.asarray(m).shape[0]), np.int32)
    return 0


@tool("gmm-align-compiled")
def gmm_align_compiled(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.align import (DenseAligner, in_degrees,
                                               pack_dense_reverse)
    from kaldi_tpu_torch.pipelines.mono import realign
    po = ParseOptions("gmm-align-compiled [opts] <model> <graphs-rspec> "
                      "<feats-rspec> <ali-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    graphs = dict(SequentialTableReader(args[1], holder="fst"))
    aligner = DenseAligner(tm.tid_to_pdf_array,
                           acoustic_scale=po["acoustic-scale"], device=device)
    ae = an = smax = 1
    for g in graphs.values():
        e, n = in_degrees(g)
        ae, an = max(ae, e), max(an, n)
        smax = max(smax, g.num_states)
    n_done = 0
    with TableWriter(args[3], holder="ivec") as w:
        def flush(batch):
            feats = dict(batch)
            dense = {k: pack_dense_reverse(graphs[k], smax, ae, an)
                     for k in feats}
            ali = realign(am, aligner, dense, list(feats), feats)
            for key in feats:
                w[key] = np.asarray(ali[key], np.int32)

        batch = []
        for key, m in SequentialTableReader(args[2], holder="mat"):
            if key not in graphs:
                log.warning("gmm-align-compiled: no graph for %s", key)
                continue
            batch.append((key, np.asarray(m, np.float32)))
            n_done += 1
            if len(batch) == ALIGN_BATCH:
                flush(batch)
                batch = []
        if batch:
            flush(batch)
    log.info("gmm-align-compiled: aligned %d utterances; GMM kernel "
             "launches %d", n_done, am.device_params().launches)
    return 0


# ---------------------------------------------------------------------------
# bin: posteriors (host code, copied from kaldi_tpu/cli/tools_bank3.py)
# ---------------------------------------------------------------------------

@tool("ali-to-post")
def ali_to_post(argv):
    po = ParseOptions("ali-to-post <ali-rspec> <post-wspec>")
    args = po.read(argv)
    with TableWriter(args[1], holder="post") as w:
        for key, ali in SequentialTableReader(args[0], holder="ivec"):
            w[key] = [[(int(t), 1.0)] for t in np.asarray(ali)]
    return 0


@tool("weight-silence-post")
def weight_silence_post(argv):
    """Scale the posterior weight of entries whose tid belongs to a
    silence phone (bin/weight-silence-post.cc: the SAT recipe's fMLLR
    pre-step)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    po = ParseOptions("weight-silence-post <weight> <silence-phones> "
                      "<model> <post-rspec> <post-wspec>")
    args = po.read(argv)
    weight = float(args[0])
    sil = {int(x) for x in args[1].split(":") if x}
    tm, _ = read_mdl(args[2], device="cpu")
    with TableWriter(args[4], holder="post") as w:
        for key, post in SequentialTableReader(args[3], holder="post"):
            out = []
            for frame in post:
                nf = []
                for tid, p in frame:
                    if tm.transition_id_to_phone(tid) in sil:
                        p *= weight
                    if p > 0:
                        nf.append((tid, p))
                out.append(nf)
            w[key] = out
    return 0


@tool("gmm-boost-silence")
def gmm_boost_silence(argv):
    """Scale mixture weights of every pdf reachable from the silence
    phones (gmmbin/gmm-boost-silence.cc)."""
    from kaldi_tpu_torch.am.serialize import read_mdl, write_mdl
    po = ParseOptions("gmm-boost-silence [--boost=1.5] <silence-phones> "
                      "<model-in> <model-out>")
    po.register("boost", float, 1.5, "weight multiplier")
    args = po.read(argv)
    sil = {int(x) for x in args[0].split(":") if x}
    tm, am = read_mdl(args[1], device="cpu")
    pdfs = set()
    for tid in range(1, tm.num_transition_ids + 1):
        if tm.transition_id_to_phone(tid) in sil:
            pdfs.add(int(tm.tid_to_pdf_array[tid]))
    for p in sorted(pdfs):
        am.weights[p] *= po["boost"]
    am.refresh()
    write_mdl(args[2], tm, am)
    log.info("gmm-boost-silence: boosted %d pdfs by %.2f", len(pdfs),
             po["boost"])
    return 0


# Port of kaldi_tpu/cli/tools_bank3.py gmm_est_fmllr, ported to intent
# (module docstring).
@tool("gmm-est-fmllr")
def gmm_est_fmllr(argv):
    """One fMLLR transform per speaker (``--spk2utt``) or utterance from
    tid posteriors: each frame's posteriors mapped to pdfs, the mixture
    posteriors on ``--device``, the statistics and the row update on the
    host (``FmllrAccs``)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import (FmllrAccs,
                                               accumulate_fmllr_from_post)
    po = ParseOptions("gmm-est-fmllr [--spk2utt=rspec] <model> "
                      "<feats-rspec> <post-rspec> <trans-wspec>")
    po.register("spk2utt", str, "", "speaker→utt map file (text)")
    _device_po(po)
    args = po.read(argv)
    if len(args) != 4:
        po.print_usage()
        return 1
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    posts = RandomAccessTableReader(args[2], holder="post")
    feats = dict(SequentialTableReader(args[1], holder="mat"))
    groups: Dict[str, List[str]] = {}
    if po["spk2utt"]:
        with open(po["spk2utt"]) as f:
            for line in f:
                parts = line.split()
                if parts:
                    groups[parts[0]] = parts[1:]
    else:
        groups = {u: [u] for u in feats}
    with TableWriter(args[3], holder="mat") as w:
        for spk, utts in groups.items():
            accs = FmllrAccs(am.dim)
            n = 0
            for u in utts:
                if u not in feats or u not in posts:
                    continue
                x = np.asarray(feats[u])
                frames = [[(int(tm.tid_to_pdf_array[tid]), p)
                           for tid, p in frame]
                          for frame in posts[u][:x.shape[0]]]
                accumulate_fmllr_from_post(accs, am, x, frames)
                n += 1
            if not n:
                continue
            W, objf = accs.update()
            w[spk] = W.astype(np.float32)
            log.info("gmm-est-fmllr: spk %s (%d utts) objf-impr %.4f",
                     spk, n, objf)
    return 0


# ---------------------------------------------------------------------------
# latbin (host code, copied from kaldi_tpu/cli/tools_bank3.py)
# ---------------------------------------------------------------------------

@tool("lattice-1best")
def lattice_1best(argv):
    from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice
    po = ParseOptions("lattice-1best [--acoustic-scale=1.0] <rspec> "
                      "<wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    args = po.read(argv)
    from kaldi_tpu_torch.lattice.functions import scale_lattice
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            if po["acoustic-scale"] != 1.0:
                scale_lattice(clat, acoustic_scale=po["acoustic-scale"])
            words, tids, cost = clat.best_path()
            lin = CompactLattice()
            states = [lin.add_state() for _ in range(len(words) + 1)]
            lin.start = states[0]
            # distribute tids evenly; exact per-arc splits live in the
            # full lattice — 1best output carries words + total cost
            per = len(tids) // max(len(words), 1) if words else 0
            pos = 0
            for i, wd in enumerate(words):
                hi = pos + per if i < len(words) - 1 else len(tids)
                lin.arcs[states[i]].append(CompactArc(
                    wd, cost if i == 0 else 0.0, 0.0,
                    tuple(tids[pos:hi]), states[i + 1]))
                pos = hi
            lin.finals[states[-1]] = (0.0, 0.0, ())
            w[key] = lin
    return 0


@tool("lattice-oracle")
def lattice_oracle(argv):
    """Oracle (minimum achievable) WER of each lattice vs the reference
    transcript (latbin/lattice-oracle.cc)."""
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("lattice-oracle <lat-rspec> <ref-rspec> "
                      "[<oracle-text-wspec>]")
    po.register("word-symbol-table", str, "", "words.txt (ref is text)")
    args = po.read(argv)
    words = (SymbolTable.read(po["word-symbol-table"])
             if po["word-symbol-table"] else None)
    refs = RandomAccessTableReader(args[1], holder="text")
    w = (TableWriter(args[2], holder="text") if len(args) > 2 else None)
    tot_err = tot_words = 0
    for key, clat in SequentialTableReader(args[0], holder="clat"):
        if key not in refs:
            continue
        ref = [words[x] if words else int(x) for x in refs[key]]
        errs, best = _oracle_path(clat, ref)
        tot_err += errs
        tot_words += len(ref)
        if w:
            w[key] = ([words.find(x) for x in best] if words
                      else [str(x) for x in best])
    if w:
        w.close()
    wer = 100.0 * tot_err / max(tot_words, 1)
    log.info("lattice-oracle: %%WER %.2f [ %d / %d ]", wer, tot_err,
             tot_words)
    print(f"%WER {wer:.2f} [ {tot_err} / {tot_words} ]")
    return 0


def _oracle_path(clat, ref: List[int]) -> Tuple[int, List[int]]:
    """Min edit distance over all lattice paths (dp over
    (state, ref position) pairs), returning (errors, best word seq)."""
    order = clat.top_order()
    n, m = clat.num_states, len(ref)
    INF = 10 ** 9
    D = np.full((n, m + 1), INF, np.int64)
    back: Dict[Tuple[int, int], Tuple[int, int, List[int]]] = {}
    if clat.start < 0:
        return len(ref), []
    D[clat.start, 0] = 0
    for s in order:
        for j in range(m + 1):
            d = D[s, j]
            if d >= INF:
                continue
            # deletion of ref word (consume ref, stay at state)
            if j < m and d + 1 < D[s, j + 1]:
                D[s, j + 1] = d + 1
                back[(s, j + 1)] = (s, j, [])
            for a in clat.arcs[s]:
                steps = ([(j, d + (0 if a.word == 0 else 1), [a.word]
                           if a.word else [])]  # insertion (or ε free)
                         + ([(j + 1, d + (a.word != ref[j]),
                              [a.word] if a.word else [])]
                            if j < m and a.word != 0 else []))
                for nj, nd, ws in steps:
                    if nd < D[a.nextstate, nj]:
                        D[a.nextstate, nj] = nd
                        back[(a.nextstate, nj)] = (s, j, ws)
    best, bs = INF, -1
    for s in clat.finals:
        if D[s, m] < best:
            best, bs = int(D[s, m]), s
    if bs < 0:
        return len(ref), []
    seq: List[int] = []
    cur = (bs, m)
    while cur != (clat.start, 0) and cur in back:
        ps, pj, ws = back[cur]
        seq = ws + seq
        cur = (ps, pj)
    return best, seq


@tool("lattice-add-penalty")
def lattice_add_penalty(argv):
    po = ParseOptions("lattice-add-penalty [--word-ins-penalty=0.0] "
                      "<rspec> <wspec>")
    po.register("word-ins-penalty", float, 0.0, "per-word graph cost")
    args = po.read(argv)
    pen = po["word-ins-penalty"]
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            for s in range(clat.num_states):
                for a in clat.arcs[s]:
                    if a.word != 0:
                        a.graph_cost += pen
            w[key] = clat
    return 0


@tool("lattice-to-post")
def lattice_to_post(argv):
    """Arc posteriors → per-frame tid posteriors
    (latbin/lattice-to-post.cc)."""
    from kaldi_tpu_torch.lattice.functions import frame_posteriors
    po = ParseOptions("lattice-to-post [--acoustic-scale=1.0] <rspec> "
                      "<post-wspec>")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    args = po.read(argv)
    with TableWriter(args[1], holder="post") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            w[key] = frame_posteriors(
                clat, acoustic_scale=po["acoustic-scale"])
    return 0


@tool("lattice-lmrescore-const-arpa")
def lattice_lmrescore_const_arpa(argv):
    """Rescore with a const-ARPA LM (an arpa-to-const-arpa file, read by
    ``read_const_arpa``) or with ARPA text.  The original parses either
    as ARPA text, so its arpa-to-const-arpa → lattice-lmrescore-const-arpa
    pipeline fails on the binary file."""
    from kaldi_tpu_torch.cli.tools_const_arpa import (is_const_arpa,
                                                      read_const_arpa)
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.rescore import compose_lm
    po = ParseOptions("lattice-lmrescore-const-arpa [--lm-scale=1.0] "
                      "<const-arpa-or-arpa> <words.txt> <lat-rspec> "
                      "<lat-wspec>")
    po.register("lm-scale", float, 1.0, "LM scale")
    args = po.read(argv)
    lm = (read_const_arpa(args[0]) if is_const_arpa(args[0])
          else ArpaModel.parse(args[0]))
    words = SymbolTable.read(args[1])
    with TableWriter(args[3], holder="clat") as w:
        for key, clat in SequentialTableReader(args[2], holder="clat"):
            w[key] = compose_lm(clat, lm.score, words,
                                scale=po["lm-scale"])
    return 0


@tool("lattice-lmrescore-pruned")
def lattice_lmrescore_pruned(argv):
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.rescore import lmrescore_diff_pruned
    po = ParseOptions("lattice-lmrescore-pruned [--lm-scale=1.0] "
                      "[--lattice-compose-beam=6] [--max-arcs=200000] "
                      "<old-arpa> <new-arpa> <words.txt> <lat-rspec> "
                      "<lat-wspec>")
    po.register("lm-scale", float, 1.0, "LM scale")
    po.register("lattice-compose-beam", float, 6.0, "composition beam")
    po.register("max-arcs", int, 200_000, "output arc cap")
    args = po.read(argv)
    old_lm = ArpaModel.parse(args[0])
    new_lm = ArpaModel.parse(args[1])
    words = SymbolTable.read(args[2])
    with TableWriter(args[4], holder="clat") as w:
        for key, clat in SequentialTableReader(args[3], holder="clat"):
            # single pruned composition with the difference LM: the
            # exact subtract-then-add intermediate is quadratic in
            # density × histories and blows up on dense lattices
            w[key] = lmrescore_diff_pruned(
                clat, old_lm, new_lm, words, lm_scale=po["lm-scale"],
                beam=po["lattice-compose-beam"], max_arcs=po["max-arcs"])
    return 0


# Copied from kaldi_tpu/cli/tools_bank3.py nnet3_average.
@tool("nnet3-average")
def nnet3_average(argv):
    from kaldi_tpu_torch.am.nnet3_io import read_nnet3, write_nnet3
    po = ParseOptions("nnet3-average <out> <in1> <in2> [...]")
    args = po.read(argv)
    models = []
    for p in args[1:]:
        with open(p, "rb") as f:
            if f.read(2) != b"\0B":
                raise KaldiError(f"{p}: not binary kaldi")
            models.append(read_nnet3(f))
    base = models[0]
    for c_i, comp in enumerate(base.components):
        for fname, fv in comp.fields.items():
            if fv.array is None:
                continue
            acc = fv.array.astype(np.float64)
            for m in models[1:]:
                acc = acc + m.components[c_i].fields[fname].array
            fv.array = (acc / len(models)).astype(fv.array.dtype)
    with open(args[0], "wb") as f:
        f.write(b"\0B")
        write_nnet3(f, base)
    log.info("nnet3-average: averaged %d models", len(models))
    return 0


# Port of kaldi_tpu/cli/tools_bank3.py nnet3_compute.
@tool("nnet3-compute")
def nnet3_compute(argv):
    """The raw TDNN-F's forward over a feature table
    (nnet3bin/nnet3-compute.cc), on ``--device``."""
    import torch
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    po = ParseOptions("nnet3-compute [--frame-subsampling-factor=3] "
                      "<raw-model> <feats-rspec> <out-wspec>")
    po.register("frame-subsampling-factor", int, 3, "output frame rate")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _, net = _load_tdnn(args[0], po["frame-subsampling-factor"], device)
    with TableWriter(args[2], holder="mat") as w, torch.no_grad():
        for key, m in SequentialTableReader(args[1], holder="mat"):
            x = torch.as_tensor(np.asarray(m, np.float32)).to(device)
            w[key] = net(x[None])[0].cpu().numpy()
    return 0
