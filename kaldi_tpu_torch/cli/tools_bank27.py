"""Port of kaldi_tpu/cli/tools_bank27.py gmm-latgen-simple and
gmm-decode-biglm-faster (parity targets gmmbin/gmm-latgen-simple.cc,
gmm-decode-biglm-faster.cc), registered in cli/tools.py's ``TOOLS``.
Both take ``--device`` (default cuda): the GMM log-likelihoods (the GMM
kernel on a card) run there.  gmm-latgen-simple decodes there too (the
dense decoder at an effectively infinite beam) and determinizes on the
host; gmm-decode-biglm-faster searches on the host (decoder/biglm.py,
the original's numpy).  gmm-latgen-faster-regtree-fmllr
(gmmbin/gmm-latgen-faster-regtree-fmllr.cc) applies each speaker's
transform, scores and decodes (cli/latgen.py ``_LatgenDecoder``) on
``--device``.
"""

from __future__ import annotations

import numpy as np

from kaldi_tpu_torch.cli.latgen import _load_hclg
from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank27.py gmm_latgen_simple_tool.
@tool("gmm-latgen-simple")
def gmm_latgen_simple_tool(argv):
    """Unpruned-reference lattice generation
    (gmmbin/gmm-latgen-simple.cc, LatticeSimpleDecoder): the dense
    decoder at an effectively infinite beam — the oracle the pruned
    latgen tools are validated against."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    po = ParseOptions("gmm-latgen-simple [opts] <model> <fst> "
                      "<feats-rspec> <lattice-wspec>")
    po.register("lattice-beam", float, 10.0, "lattice beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    HCLG = _load_hclg(args[1])
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array, DenseDecoderConfig(
        beam=1e9, lattice_beam=po["lattice-beam"],
        acoustic_scale=po["acoustic-scale"]), device=device)
    n = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, feats in SequentialTableReader(args[2], holder="mat"):
            lat, _best = dec.decode_lattice(
                am.loglikes(np.asarray(feats, np.float32)))
            w[key] = determinize_lattice_pruned(lat,
                                                po["lattice-beam"])
            n += 1
    log.info("gmm-latgen-simple: %d utterances (unpruned); GMM kernel "
             "launches %d", n, am.device_params().launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank27.py gmm_decode_biglm_faster_tool.
@tool("gmm-decode-biglm-faster")
def gmm_decode_biglm_faster_tool(argv):
    """Best-path decoding with on-the-fly big-LM rescoring
    (gmmbin/gmm-decode-biglm-faster.cc): word scores of the small-LM
    HCLG are swapped for the big LM's during the search; outputs
    transcripts (+ optional alignments) rather than lattices."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.decoder.biglm import (BiglmDecoderConfig,
                                               BiglmFasterDecoder)
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("gmm-decode-biglm-faster [opts] <model> <fst> "
                      "<old-arpa> <new-arpa> <feats-rspec> "
                      "<words-wspec> [<ali-wspec>]")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("max-active", int, 7000, "max active tokens")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt (REQUIRED)")
    _device_po(po)
    args = po.read(argv)
    if not po["word-symbol-table"]:
        raise KaldiError("gmm-decode-biglm-faster: "
                         "--word-symbol-table required")
    tm, am = read_mdl(args[0], device=resolve_device(po["device"]))
    HCLG = _load_hclg(args[1])
    old_lm = ArpaModel.parse(args[2])
    new_lm = ArpaModel.parse(args[3])
    words = SymbolTable.read(po["word-symbol-table"])
    dec = BiglmFasterDecoder(
        HCLG, tm.tid_to_pdf_array, old_lm.score, new_lm.score, words,
        BiglmDecoderConfig(beam=po["beam"],
                           max_active=po["max-active"],
                           acoustic_scale=po["acoustic-scale"],
                           history_len=max(new_lm.order - 1, 1)))
    awriter = (TableWriter(args[6], holder="ivec")
               if len(args) > 6 else None)
    n = 0
    with TableWriter(args[5], holder="text") as w:
        for key, feats in SequentialTableReader(args[4], holder="mat"):
            ll = am.loglikes(np.asarray(feats, np.float32)).cpu().numpy()
            tids, ols, cost = dec.decode(ll)
            w[key] = [words.find(o) for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("gmm-decode-biglm-faster: %d utterances; GMM kernel "
             "launches %d", n, am.device_params().launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank27.py gmm_latgen_faster_regtree_fmllr_tool.
@tool("gmm-latgen-faster-regtree-fmllr")
def gmm_latgen_faster_regtree_fmllr_tool(argv):
    """Lattice generation with per-speaker regression-tree fMLLR
    transforms (gmmbin/gmm-latgen-faster-regtree-fmllr.cc): the
    regtree root transform is applied in feature space, then the
    standard latgen path runs, all on ``--device``."""
    import torch
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.am.transforms import apply_transform
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder
    from kaldi_tpu_torch.core.table import RandomAccessTableReader
    po = ParseOptions("gmm-latgen-faster-regtree-fmllr [opts] <model> "
                      "<fst> <transforms-rspec> <feats-rspec> "
                      "<lattice-wspec>")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("utt2spk", str, "", "utterance→speaker map rspec")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, am = read_mdl(args[0], device=device)
    dec = _LatgenDecoder(_load_hclg(args[1]), tm.tid_to_pdf_array,
                         po["beam"], po["lattice-beam"],
                         po["acoustic-scale"],
                         max_active=po["max-active"], device=device)
    trans = RandomAccessTableReader(args[2], holder="mat")
    utt2spk = {}
    if po["utt2spk"]:
        for u, s in SequentialTableReader(po["utt2spk"],
                                          holder="text"):
            utt2spk[u] = s[0]
    n = 0
    with TableWriter(args[4], holder="clat") as w:
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            spk = utt2spk.get(key, key)
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
            if spk in trans:
                x = apply_transform(x, np.asarray(trans[spk])).contiguous()
            w[key] = dec.decode_to_clat(am.loglikes(x))
            n += 1
    log.info("gmm-latgen-faster-regtree-fmllr: %d utterances; GMM kernel "
             "launches %d", n, am.device_params().launches)
    return 0
