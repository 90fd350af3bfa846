"""Port of kaldi_tpu/cli/tools_bank4.py: the utils/ data-directory
scripts (parity targets utils/{utt2spk_to_spk2utt.pl,
spk2utt_to_utt2spk.pl, validate_data_dir.sh, fix_data_dir.sh,
subset_data_dir.sh, split_data.sh, sym2int.pl, int2sym.pl}), long-audio
segmentation (steps/cleanup/segment_long_utterances.sh), bin/{copy-vector,
vector-sum}.cc, featbin/wav-copy.cc and kwsbin/kws-search.cc, registered
in cli/tools.py's ``TOOLS``.  Host code, copied (pipelines/datadir.py,
pipelines/segment.py, kws.py's ``LatticeIndex`` or the direct
per-lattice search), so their files equal the original's;
segment-long-utterances runs its energy VAD on ``--device`` (default
cuda).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import (RandomAccessTableReader,
                                        SequentialTableReader, TableWriter)
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# utils/: data-directory scripts
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank4.py utt2spk_to_spk2utt_tool.
@tool("utt2spk-to-spk2utt")
def utt2spk_to_spk2utt_tool(argv):
    from kaldi_tpu_torch.pipelines.datadir import (_read_table, _write_table,
                                                   utt2spk_to_spk2utt)
    po = ParseOptions("utt2spk-to-spk2utt <utt2spk> [<spk2utt>]")
    args = po.read(argv)
    s2u = utt2spk_to_spk2utt(_read_table(args[0]))
    table = {s: " ".join(us) for s, us in s2u.items()}
    if len(args) > 1:
        _write_table(args[1], table)
    else:
        for s in sorted(table):
            print(f"{s} {table[s]}")
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py spk2utt_to_utt2spk_tool.
@tool("spk2utt-to-utt2spk")
def spk2utt_to_utt2spk_tool(argv):
    from kaldi_tpu_torch.pipelines.datadir import (_read_table, _write_table,
                                                   spk2utt_to_utt2spk)
    po = ParseOptions("spk2utt-to-utt2spk <spk2utt> [<utt2spk>]")
    args = po.read(argv)
    u2s = spk2utt_to_utt2spk(
        {s: v.split() for s, v in _read_table(args[0]).items()})
    if len(args) > 1:
        _write_table(args[1], u2s)
    else:
        for u in sorted(u2s):
            print(f"{u} {u2s[u]}")
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py validate_data_dir_tool.
@tool("validate-data-dir")
def validate_data_dir_tool(argv):
    from kaldi_tpu_torch.pipelines.datadir import (read_data_dir,
                                                   validate_data_dir)
    po = ParseOptions("validate-data-dir [--no-text] <data-dir>")
    po.register("no-text", bool, False, "do not require a text file")
    args = po.read(argv)
    problems = validate_data_dir(read_data_dir(args[0]),
                                 require_text=not po["no-text"])
    for p in problems:
        log.warning("validate-data-dir: %s", p)
    if not problems:
        log.info("validate-data-dir: %s is valid", args[0])
    return 1 if problems else 0


# Copied from kaldi_tpu/cli/tools_bank4.py fix_data_dir_tool.
@tool("fix-data-dir")
def fix_data_dir_tool(argv):
    from kaldi_tpu_torch.pipelines.datadir import (fix_data_dir, read_data_dir,
                                                   write_data_dir)
    po = ParseOptions("fix-data-dir <data-dir> [<out-dir>]")
    args = po.read(argv)
    fixed = fix_data_dir(read_data_dir(args[0]))
    write_data_dir(args[1] if len(args) > 1 else args[0], fixed)
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py subset_data_dir_tool.
@tool("subset-data-dir")
def subset_data_dir_tool(argv):
    from kaldi_tpu_torch.pipelines.datadir import (read_data_dir,
                                                   subset_data_dir,
                                                   write_data_dir)
    po = ParseOptions(
        "subset-data-dir [--first-n=N|--per-spk=N|--spk-list=f|"
        "--utt-list=f] <src-dir> <dst-dir>")
    po.register("first-n", int, 0, "keep first N utterances")
    po.register("per-spk", int, 0, "keep N utterances per speaker")
    po.register("spk-list", str, "", "file listing speakers to keep")
    po.register("utt-list", str, "", "file listing utterances to keep")
    args = po.read(argv)
    d = read_data_dir(args[0])
    if po["utt-list"]:
        sub = subset_data_dir(d, utt_list=open(po["utt-list"]).read().split())
    elif po["spk-list"]:
        sub = subset_data_dir(d, speakers=open(po["spk-list"]).read().split())
    elif po["per-spk"]:
        sub = subset_data_dir(d, per_spk=po["per-spk"])
    elif po["first-n"]:
        sub = subset_data_dir(d, n=po["first-n"])
    else:
        raise KaldiError("subset-data-dir: no selection flag given")
    write_data_dir(args[1], sub)
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py split_data_tool.
@tool("split-data")
def split_data_tool(argv):
    from kaldi_tpu_torch.pipelines.datadir import (read_data_dir,
                                                   split_data_dir,
                                                   write_data_dir)
    po = ParseOptions("split-data <data-dir> <num-jobs>")
    args = po.read(argv)
    nj = int(args[1])
    shards = split_data_dir(read_data_dir(args[0]), nj)
    for j, sh in enumerate(shards, 1):
        write_data_dir(os.path.join(args[0], f"split{nj}", str(j)), sh)
    log.info("split-data: wrote %d shards under %s/split%d",
             len(shards), args[0], nj)
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py _sym_map_lines.
def _sym_map_lines(args, po, to_int: bool):
    from kaldi_tpu_torch.fst.fst import SymbolTable
    tab = SymbolTable.read(args[0])
    fin = open(args[1]) if len(args) > 1 else sys.stdin
    fout = open(args[2], "w") if len(args) > 2 else sys.stdout
    oov = po["map-oov"]
    for line in fin:
        parts = line.split()
        if not parts:
            continue
        mapped = [parts[0]]
        for w in parts[1:]:
            if to_int:
                if w in tab:
                    mapped.append(str(tab[w]))
                elif oov:
                    mapped.append(str(tab[oov]) if oov in tab else oov)
                else:
                    raise KaldiError(f"sym2int: OOV symbol {w}")
            else:
                mapped.append(tab.find(int(w)))
        fout.write(" ".join(mapped) + "\n")
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py sym2int_tool.
@tool("sym2int")
def sym2int_tool(argv):
    po = ParseOptions("sym2int [--map-oov=<sym>] <symtab> [<in>] [<out>]\n"
                      "First field of each line is a key, kept verbatim.")
    po.register("map-oov", str, "", "map out-of-vocabulary words to this")
    args = po.read(argv)
    return _sym_map_lines(args, po, to_int=True)


# Copied from kaldi_tpu/cli/tools_bank4.py int2sym_tool.
@tool("int2sym")
def int2sym_tool(argv):
    po = ParseOptions("int2sym <symtab> [<in>] [<out>]\n"
                      "First field of each line is a key, kept verbatim.")
    po.register("map-oov", str, "", "unused; accepted for symmetry")
    args = po.read(argv)
    return _sym_map_lines(args, po, to_int=False)


# ---------------------------------------------------------------------------
# steps/cleanup: long-audio segmentation
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank4.py segment_long_utterances_tool.
@tool("segment-long-utterances")
def segment_long_utterances_tool(argv):
    from kaldi_tpu_torch.pipelines.segment import (SegmentationOptions,
                                                   segment_long_audio,
                                                   write_segments)
    po = ParseOptions(
        "segment-long-utterances [opts] <wav-rspec> <segments-file>")
    opts = SegmentationOptions()
    po.register("min-silence-length", float, opts.min_silence_length,
                "gaps shorter than this merge (s)")
    po.register("min-segment-length", float, opts.min_segment_length,
                "drop shorter segments (s)")
    po.register("max-segment-length", float, opts.max_segment_length,
                "split longer segments (s)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    opts.min_silence_length = po["min-silence-length"]
    opts.min_segment_length = po["min-segment-length"]
    opts.max_segment_length = po["max-segment-length"]
    reco2segs: Dict[str, List] = {}
    total = 0
    for reco, (wave, rate) in SequentialTableReader(args[0], holder="wav"):
        segs = segment_long_audio(np.asarray(wave, np.float32), rate, opts,
                                  device=device)
        reco2segs[reco] = segs
        total += len(segs)
    write_segments(args[1], reco2segs)
    log.info("segment-long-utterances: %d segments from %d recordings",
             total, len(reco2segs))
    return 0


# ---------------------------------------------------------------------------
# bin utilities
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank4.py copy_vector_tool.
@tool("copy-vector")
def copy_vector_tool(argv):
    po = ParseOptions("copy-vector <vec-rspec> <vec-wspec>")
    po.register("scale", float, 1.0, "scale vectors by this")
    args = po.read(argv)
    with TableWriter(args[1], holder="vec") as w:
        for key, v in SequentialTableReader(args[0], holder="vec"):
            w[key] = np.asarray(v) * po["scale"]
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py vector_sum_tool.
@tool("vector-sum")
def vector_sum_tool(argv):
    po = ParseOptions(
        "vector-sum <vec-rspec1> [<vec-rspec2> ...] <vec-wspec>\n"
        "Key-wise sum across inputs (bin/vector-sum.cc table mode).")
    args = po.read(argv)
    if len(args) < 2:
        raise KaldiError("vector-sum: need >=1 input and an output")
    readers = [RandomAccessTableReader(r, holder="vec") for r in args[1:-1]]
    with TableWriter(args[-1], holder="vec") as w:
        for key, v in SequentialTableReader(args[0], holder="vec"):
            acc = np.asarray(v, np.float64)
            for r in readers:
                if key not in r:
                    raise KaldiError(f"vector-sum: {key} missing")
                acc = acc + np.asarray(r[key], np.float64)
            w[key] = acc.astype(np.float32)
    return 0


# Copied from kaldi_tpu/cli/tools_bank4.py wav_copy_tool.
@tool("wav-copy")
def wav_copy_tool(argv):
    po = ParseOptions("wav-copy <wav-rspec> <wav-wspec>")
    args = po.read(argv)
    with TableWriter(args[1], holder="wav") as w:
        for key, (samples, rate) in SequentialTableReader(args[0],
                                                          holder="wav"):
            # reads come back as float32 at int16 scale; the writer
            # treats float input as [-1,1], so pass int16 through
            w[key] = (np.asarray(samples).astype(np.int16), rate)
    return 0


# ---------------------------------------------------------------------------
# kwsbin
# ---------------------------------------------------------------------------

# Copied from kaldi_tpu/cli/tools_bank4.py kws_search_tool.
@tool("kws-search")
def kws_search_tool(argv):
    from kaldi_tpu_torch.kws import LatticeIndex, keyword_search
    po = ParseOptions(
        "kws-search [opts] <lattice-rspec> <keywords-file> <hits-wspec>\n"
        "keywords-file lines: <kw-id> <word-int> [<word-int> ...];\n"
        "hit lines: <utt> <t-begin> <t-end> <posterior>.")
    po.register("min-posterior", float, 0.01, "drop weaker hits")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("use-index", bool, True,
                "build the inverted index (factor-transducer role) "
                "instead of per-lattice search")
    args = po.read(argv)
    keywords = {}
    with open(args[1]) as f:
        for line in f:
            parts = line.split()
            if parts:
                keywords[parts[0]] = [int(x) for x in parts[1:]]
    lattices = {k: v for k, v in
                SequentialTableReader(args[0], holder="clat")}
    if po["use-index"]:
        index = LatticeIndex.build(lattices,
                                   acoustic_scale=po["acoustic-scale"])
        results = {kw: index.search(seq, po["min-posterior"])
                   for kw, seq in keywords.items()}
    else:
        results = keyword_search(lattices, keywords, po["min-posterior"],
                                 po["acoustic-scale"])
    with TableWriter(args[2], holder="text") as w:
        for kw in sorted(results):
            for i, h in enumerate(results[kw]):
                w[f"{kw}-{i + 1}"] = [h.utt, str(h.begin_frame),
                                      str(h.end_frame),
                                      f"{h.posterior:.4f}"]
    return 0
