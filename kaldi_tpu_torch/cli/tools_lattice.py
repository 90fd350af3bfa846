"""The lattice tools on the copied lattice host modules
(lattice/ops.py, word_align.py, phone_align.py, ctm.py).

Port of ``lattice-to-ctm`` (kaldi_tpu/cli/tools.py); ``lattice-union``,
``lattice-interp``, ``lattice-push``, ``lattice-to-phone-lattice``,
``lattice-confidence`` and ``lattice-equivalent`` (tools_bank5.py);
``lattice-align-phones``, ``lattice-boost-ali``, ``lattice-minimize`` and
``lattice-combine`` (tools_bank14.py); ``lattice-difference`` (with its
``_clat_paths``), ``nbest-to-lattice`` and ``nbest-to-prons``
(tools_bank17.py); ``lattice-align-words-lexicon`` (tools_bank21.py) and
``lattice-align-words`` (tools_extra.py).  Each is the original's host
code, copied with its options and arguments, registered in cli/tools.py's
``TOOLS``; the tools that read a model read only its transition model,
on the CPU.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)

log = get_logger(__name__)


# Copied from kaldi_tpu/cli/tools.py lattice_to_ctm.
@tool("lattice-to-ctm")
def lattice_to_ctm(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.ctm import best_path_ctm
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions(
        "lattice-to-ctm <model> <words.txt> <lattice-rspec> [<ctm-file>]")
    po.register("frame-shift", float, 0.01, "frame shift seconds")
    po.register("silence-phones", str, "1", "colon-separated silence ids")
    po.register("lexicon", str, "", "lexicon text file (word phone...) "
                "with phones.txt beside it, for exact word alignment")
    po.register("phone-symbol-table", str, "", "phones.txt (with --lexicon)")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    words = SymbolTable.read(args[1])
    sil = {int(x) for x in po["silence-phones"].split(":") if x}
    prons = None
    if po["lexicon"]:
        phones = SymbolTable.read(po["phone-symbol-table"])
        prons = {}
        with open(po["lexicon"]) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] in words:
                    prons.setdefault(words[parts[0]], []).append(
                        [phones[p] for p in parts[1:]])
    out = open(args[3], "w") if len(args) > 3 else sys.stdout
    for key, clat in SequentialTableReader(args[2], holder="clat"):
        for entry in best_path_ctm(clat, tm, words, key, sil,
                                   po["frame-shift"], prons=prons):
            print(entry, file=out)
    if len(args) > 3:
        out.close()
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py lattice_union_tool.
@tool("lattice-union")
def lattice_union_tool(argv):
    from kaldi_tpu_torch.lattice.ops import lattice_union
    po = ParseOptions("lattice-union <clat-rspec1> <clat-rspec2> "
                      "<clat-wspec>")
    args = po.read(argv)
    second = RandomAccessTableReader(args[1], holder="clat")
    with TableWriter(args[2], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            try:
                other = second[key]
            except KeyError:
                w[key] = clat
                continue
            w[key] = lattice_union(clat, other)
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py lattice_interp_tool.
@tool("lattice-interp")
def lattice_interp_tool(argv):
    from kaldi_tpu_torch.lattice.ops import interp_lattices
    po = ParseOptions("lattice-interp [--alpha=0.5] <clat-rspec1> "
                      "<clat-rspec2> <clat-wspec>")
    po.register("alpha", float, 0.5, "weight on the first lattice")
    args = po.read(argv)
    second = RandomAccessTableReader(args[1], holder="clat")
    n_done = n_empty = 0
    with TableWriter(args[2], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            out = interp_lattices(clat, second[key], po["alpha"])
            if out is None:
                log.warning("lattice-interp: %s — empty composition", key)
                n_empty += 1
                continue
            w[key] = out
            n_done += 1
    log.info("lattice-interp: %d done, %d empty", n_done, n_empty)
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py lattice_push_tool.
@tool("lattice-push")
def lattice_push_tool(argv):
    from kaldi_tpu_torch.lattice.ops import push_lattice
    po = ParseOptions("lattice-push <clat-rspec> <clat-wspec>")
    args = po.read(argv)
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            w[key] = push_lattice(clat)
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py lattice_to_phone_lattice_tool.
@tool("lattice-to-phone-lattice")
def lattice_to_phone_lattice_tool(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.ops import lattice_to_phone_lattice
    po = ParseOptions("lattice-to-phone-lattice <model> <clat-rspec> "
                      "<clat-wspec>")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    with TableWriter(args[2], holder="clat") as w:
        for key, clat in SequentialTableReader(args[1], holder="clat"):
            w[key] = lattice_to_phone_lattice(clat, tm)
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py lattice_confidence_tool.
@tool("lattice-confidence")
def lattice_confidence_tool(argv):
    from kaldi_tpu_torch.lattice.ops import lattice_confidence
    po = ParseOptions("lattice-confidence <clat-rspec> <confidence-wspec> "
                      "(text: utt -> best/second-best cost gap)")
    args = po.read(argv)
    with TableWriter(args[1], holder="text") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            c = lattice_confidence(clat)
            w[key] = f"{min(c, 1e10):.4f}"
    return 0


# Copied from kaldi_tpu/cli/tools_bank5.py lattice_equivalent_tool.
@tool("lattice-equivalent")
def lattice_equivalent_tool(argv):
    from kaldi_tpu_torch.lattice.ops import lattices_equivalent
    po = ParseOptions("lattice-equivalent [--delta=0.001] <clat-rspec1> "
                      "<clat-rspec2>  (exit 0 iff all pairs equivalent)")
    po.register("delta", float, 1e-3, "weight tolerance")
    args = po.read(argv)
    second = RandomAccessTableReader(args[1], holder="clat")
    n_bad = n = 0
    for key, clat in SequentialTableReader(args[0], holder="clat"):
        n += 1
        if not lattices_equivalent(clat, second[key], po["delta"]):
            log.warning("lattice-equivalent: %s differs", key)
            n_bad += 1
    log.info("lattice-equivalent: %d/%d equivalent", n - n_bad, n)
    return 1 if n_bad else 0


# Copied from kaldi_tpu/cli/tools_bank14.py lattice_align_phones_tool.
@tool("lattice-align-phones")
def lattice_align_phones_tool(argv):
    """Split lattice arcs at phone boundaries; olabels become phone ids
    with --replace-output-symbols (latbin/lattice-align-phones.cc)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.phone_align import phone_align_lattice
    po = ParseOptions("lattice-align-phones [opts] <model> <clat-rspec> "
                      "<clat-wspec>")
    po.register("replace-output-symbols", bool, True,
                "olabel = phone id on every arc")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    n = 0
    with TableWriter(args[2], holder="clat") as w:
        for key, clat in SequentialTableReader(args[1], holder="clat"):
            w[key] = phone_align_lattice(
                clat, tm,
                replace_output_symbols=po["replace-output-symbols"])
            n += 1
    log.info("lattice-align-phones: %d lattices", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank14.py lattice_boost_ali_tool.
@tool("lattice-boost-ali")
def lattice_boost_ali_tool(argv):
    """Boosted MMI: decrease graph costs by b × #frame-phone-errors vs
    the numerator alignment (latbin/lattice-boost-ali.cc)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.phone_align import boost_lattice_ali
    po = ParseOptions("lattice-boost-ali [opts] <model> <clat-rspec> "
                      "<ali-rspec> <clat-wspec>")
    po.register("b", float, 0.05, "boosting constant")
    po.register("silence-phones", str, "", "colon-separated phone ids")
    po.register("max-silence", float, 0.0,
                "error contribution of each silence frame")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    sil = {int(p) for p in po["silence-phones"].split(":") if p}
    ali_r = RandomAccessTableReader(args[2], holder="ivec")
    n = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, clat in SequentialTableReader(args[1], holder="clat"):
            if key not in ali_r:
                log.warning("lattice-boost-ali: no alignment for %s", key)
                continue
            try:
                w[key] = boost_lattice_ali(
                    clat, tm, np.asarray(ali_r[key]).tolist(), po["b"],
                    silence_phones=sil,
                    max_silence_error=po["max-silence"])
            except KaldiError as e:
                log.warning("lattice-boost-ali: skipping %s: %s", key, e)
                continue
            n += 1
    log.info("lattice-boost-ali: boosted %d lattices (b=%.3f)", n, po["b"])
    return 0


# Copied from kaldi_tpu/cli/tools_bank14.py lattice_minimize_tool.
@tool("lattice-minimize")
def lattice_minimize_tool(argv):
    """Suffix-sharing minimization of compact lattices
    (latbin/lattice-minimize.cc)."""
    from kaldi_tpu_torch.lattice.phone_align import minimize_lattice
    po = ParseOptions("lattice-minimize <clat-rspec> <clat-wspec>")
    args = po.read(argv)
    n_states_in = n_states_out = 0
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            out = minimize_lattice(clat)
            n_states_in += clat.num_states
            n_states_out += out.num_states
            w[key] = out
    log.info("lattice-minimize: %d -> %d states", n_states_in,
             n_states_out)
    return 0


# Copied from kaldi_tpu/cli/tools_bank14.py lattice_combine_tool.
@tool("lattice-combine")
def lattice_combine_tool(argv):
    """System combination: union of per-system lattices with the
    posterior scales folded into graph costs
    (latbin/lattice-combine.cc)."""
    import math
    from kaldi_tpu_torch.lattice.lattice import CompactArc
    from kaldi_tpu_torch.lattice.ops import lattice_union
    po = ParseOptions("lattice-combine [--lat-weights=w1:w2:...] "
                      "<clat-rspec1> <clat-rspec2> [...] <clat-wspec>")
    po.register("lat-weights", str, "", "per-system posterior weights")
    args = po.read(argv)
    if len(args) < 3:
        po.print_usage()
        return 1
    n_sys = len(args) - 1
    weights = ([float(x) for x in po["lat-weights"].split(":")]
               if po["lat-weights"] else [1.0 / n_sys] * n_sys)
    if len(weights) != n_sys:
        raise KaldiError("lattice-combine: #weights != #systems")

    def scaled(clat, wgt):
        out = type(clat)()
        for _ in range(clat.num_states):
            out.add_state()
        out.start = clat.start
        add = -math.log(max(wgt, 1e-30))
        for s in range(clat.num_states):
            first = s == clat.start
            for a in clat.arcs[s]:
                out.arcs[s].append(CompactArc(
                    a.word, a.graph_cost + (add if first else 0.0),
                    a.acoustic_cost, a.tids, a.nextstate))
            if s in clat.finals:
                gc, ac, tids = clat.finals[s]
                out.finals[s] = (gc + (add if first else 0.0), ac, tids)
        return out

    readers = [RandomAccessTableReader(a, holder="clat")
               for a in args[1:-1]]
    n = 0
    with TableWriter(args[-1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            out = scaled(clat, weights[0])
            for i, r in enumerate(readers):
                if key in r:
                    out = lattice_union(out, scaled(r[key],
                                                    weights[i + 1]))
            w[key] = out
            n += 1
    log.info("lattice-combine: combined %d keys from %d systems",
             n, n_sys)
    return 0


# Copied from kaldi_tpu/cli/tools_bank17.py lattice_difference_tool.
@tool("lattice-difference")
def lattice_difference_tool(argv):
    """Remove from each lattice every path whose WORD sequence appears
    in the corresponding second lattice (latbin/lattice-difference.cc
    — used to exclude the numerator path from MCE denominators)."""
    from kaldi_tpu_torch.lattice.lattice import CompactArc, CompactLattice
    from kaldi_tpu_torch.lattice.ops import enumerate_paths
    po = ParseOptions("lattice-difference <clat-rspec> <sub-rspec> "
                      "<clat-wspec>")
    args = po.read(argv)
    sub_r = RandomAccessTableReader(args[1], holder="clat")
    n_done = n_empty = 0
    with TableWriter(args[2], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            if key not in sub_r:
                w[key] = clat
                n_done += 1
                continue
            remove = set(enumerate_paths(sub_r[key]).keys())
            out = CompactLattice()
            kept = 0
            # path-level difference via enumeration (lattices are
            # determinized/word-deterministic and small post-decode)
            s0 = out.add_state()
            out.start = s0
            for path in _clat_paths(clat):
                words = tuple(a.word for a in path["arcs"]
                              if a.word != 0)
                if words in remove:
                    continue
                cur = s0
                for a in path["arcs"]:
                    nxt = out.add_state()
                    out.arcs[cur].append(CompactArc(
                        a.word, a.graph_cost, a.acoustic_cost,
                        a.tids, nxt))
                    cur = nxt
                fgc, fac, ftids = path["final"]
                out.finals[cur] = (fgc, fac, tuple(ftids))
                kept += 1
            if kept:
                w[key] = out
                n_done += 1
            else:
                n_empty += 1
    log.info("lattice-difference: wrote %d, %d became empty", n_done,
             n_empty)
    return 0


# Copied from kaldi_tpu/cli/tools_bank17.py _clat_paths.
def _clat_paths(clat, limit: int = 20000):
    """Yield {'arcs': [CompactArc...], 'final': (gc, ac, tids)}."""
    if clat.start < 0:
        return
    stack = [(clat.start, [])]
    n = 0
    while stack:
        s, arcs = stack.pop()
        fin = clat.finals.get(s)
        if fin is not None:
            yield {"arcs": arcs, "final": fin}
            n += 1
            if n >= limit:
                raise KaldiError("too many lattice paths to enumerate")
        for a in clat.arcs[s]:
            stack.append((a.nextstate, arcs + [a]))


# Copied from kaldi_tpu/cli/tools_bank17.py nbest_to_lattice_tool.
@tool("nbest-to-lattice")
def nbest_to_lattice_tool(argv):
    """Union utt-N single-path lattices back into one lattice per
    utterance (latbin/nbest-to-lattice.cc)."""
    from kaldi_tpu_torch.lattice.ops import lattice_union
    po = ParseOptions("nbest-to-lattice <nbest-rspec> <clat-wspec>")
    args = po.read(argv)
    groups: Dict[str, List] = {}
    order: List[str] = []
    for key, clat in SequentialTableReader(args[0], holder="clat"):
        utt = key.rsplit("-", 1)[0]
        if utt not in groups:
            groups[utt] = []
            order.append(utt)
        groups[utt].append(clat)
    with TableWriter(args[1], holder="clat") as w:
        for utt in order:
            lat = groups[utt][0]
            for other in groups[utt][1:]:
                lat = lattice_union(lat, other)
            w[utt] = lat
    log.info("nbest-to-lattice: %d utterances from %d paths",
             len(order), sum(len(g) for g in groups.values()))
    return 0


# Copied from kaldi_tpu/cli/tools_bank17.py nbest_to_prons_tool.
@tool("nbest-to-prons")
def nbest_to_prons_tool(argv):
    """Word + pronunciation lines from single-path lattices
    (latbin/nbest-to-prons.cc): '<utt> <t-start> <t-end> <word>
    <phones...>' via the word-aligned tid strings."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.lattice.word_align import word_align_lattice
    po = ParseOptions("nbest-to-prons <model> <lexicon-file> "
                      "<nbest-rspec> <prons-wspec>\n"
                      "lexicon lines: <word-int> <phone-int>...")
    args = po.read(argv)
    tm, _ = read_mdl(args[0], device="cpu")
    prons: Dict[int, List[List[int]]] = {}
    with open(args[1]) as f:
        for line in f:
            parts = [int(x) for x in line.split()]
            if parts:
                prons.setdefault(parts[0], []).append(parts[1:])
    sil = {p for p in range(1, 2)}         # phone 1 = SIL convention
    n = 0
    with TableWriter(args[3], holder="text") as w:
        for key, clat in SequentialTableReader(args[2], holder="clat"):
            aligned, ok = word_align_lattice(clat, tm, prons, sil)
            if not ok:
                log.warning("nbest-to-prons: %s word-align failed", key)
            lines = []
            t = 0
            s = aligned.start
            while True:
                fin = aligned.finals.get(s)
                if fin is not None and not aligned.arcs[s]:
                    break
                if not aligned.arcs[s]:
                    break
                a = aligned.arcs[s][0]
                dur = len(a.tids)
                if a.word != 0:
                    ph = [tm.transition_id_to_phone(x)
                          for x in a.tids]
                    dedup = [p for i, p in enumerate(ph)
                             if i == 0 or p != ph[i - 1]]
                    lines.append(f"{t} {t + dur} {a.word} "
                                 + " ".join(str(p) for p in dedup))
                t += dur
                s = a.nextstate
            w[key] = " ; ".join(lines).split() if lines else ["-"]
            n += 1
    log.info("nbest-to-prons: %d paths", n)
    return 0


# Copied from kaldi_tpu/cli/tools_bank21.py lattice_align_words_lexicon_tool.
@tool("lattice-align-words-lexicon")
def lattice_align_words_lexicon_tool(argv):
    """Word-align lattices using an align-lexicon file
    (latbin/lattice-align-words-lexicon.cc): each line is
    '<word-int> <word-int> <phone-int>...' (steps/..
    align_lexicon.int format, covering word-position-independent
    lexicons that phones/word_boundary.int cannot)."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.core import io as kio
    from kaldi_tpu_torch.lattice.word_align import word_align_lattice
    po = ParseOptions("lattice-align-words-lexicon [opts] "
                      "<align-lexicon.int> <model> <lat-rspec> "
                      "<lat-wspec>")
    po.register("silence-phones", str, "", "colon-separated phone ids "
                "treated as optional silence")
    args = po.read(argv)
    prons: Dict[int, List[List[int]]] = {}
    with kio.open_rxfilename(args[0]) as f:
        for raw in f.read().decode().splitlines():
            parts = raw.split()
            if len(parts) < 3:
                continue
            # cols: printed-word word phone...; both word columns are
            # integer ids (<eps> rows map silence — keep word 0 too)
            prons.setdefault(int(parts[1]), []).append(
                [int(p) for p in parts[2:]])
    tm, _ = read_mdl(args[1], device="cpu")
    sil = {int(x) for x in po["silence-phones"].split(":") if x}
    # <eps> pronunciation rows define silence phones implicitly
    for pron in prons.get(0, []):
        sil.update(pron)
    n = n_bad = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, clat in SequentialTableReader(args[2], holder="clat"):
            aligned, ok = word_align_lattice(clat, tm, prons, sil)
            n_bad += not ok
            w[key] = aligned
            n += 1
    if n_bad:
        log.warning("%d lattices had best-effort word splits", n_bad)
    log.info("lattice-align-words-lexicon: %d lattices", n)
    return 0


# Copied from kaldi_tpu/cli/tools_extra.py lattice_align_words.
@tool("lattice-align-words")
def lattice_align_words(argv):
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.fst.fst import SymbolTable
    from kaldi_tpu_torch.lattice.word_align import word_align_lattice
    po = ParseOptions("lattice-align-words [opts] <lexicon> <phones.txt> "
                      "<words.txt> <model> <lat-rspec> <lat-wspec>")
    po.register("silence-phones", str, "1", "colon-separated phone ids")
    args = po.read(argv)
    phones = SymbolTable.read(args[1])
    words = SymbolTable.read(args[2])
    tm, _ = read_mdl(args[3], device="cpu")
    prons: Dict[int, List[List[int]]] = {}
    with open(args[0]) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[0] in words:
                prons.setdefault(words[parts[0]], []).append(
                    [phones[p] for p in parts[1:]])
    sil = {int(x) for x in po["silence-phones"].split(":") if x}
    n_bad = 0
    with TableWriter(args[5], holder="clat") as w:
        for key, clat in SequentialTableReader(args[4], holder="clat"):
            aligned, ok = word_align_lattice(clat, tm, prons, sil)
            n_bad += not ok
            w[key] = aligned
    if n_bad:
        log.warning("%d lattices had best-effort word splits", n_bad)
    return 0

