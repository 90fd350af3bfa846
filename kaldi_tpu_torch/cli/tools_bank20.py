"""Port of kaldi_tpu/cli/tools_bank20.py nnet3-latgen-faster-batch (parity
target nnet3bin/nnet3-latgen-faster-batch.cc, the cudadecoder batch
contract), registered in cli/tools.py's ``TOOLS``.  It takes
``--device`` (default cuda): the raw TDNN-F scores each utterance there,
then every utterance decodes there, as in the original: one at a time
by cli/latgen.py's ``_LatgenDecoder`` (the dense decoder) on graphs of
at most ``DENSE_LIMIT`` states, ``--batch-size`` at a time by
``BeamDecoder.decode_lattice_batch`` above it, each raw lattice then
determinized on the host.  A batch is padded to its longest utterance:
the original's 64-frame padding served XLA's compile cache, and the
decoder masks padded frames by each utterance's length, so the lattices
are the same.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)

# graphs up to this many states decode per utterance on the dense decoder
DENSE_LIMIT = 20000


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Port of kaldi_tpu/cli/tools_bank20.py nnet3_latgen_faster_batch_tool.
@tool("nnet3-latgen-faster-batch")
def nnet3_latgen_faster_batch_tool(argv):
    """Batched lattice decoding: utterances padded into device
    batches, decoded by the vectorized sweep in one program
    (nnet3bin/nnet3-latgen-faster-batch.cc / the cudadecoder batch
    contract).  Small graphs decode per utterance on the dense decoder.
    The log line gives the frames, the nnet's and the decode's
    seconds."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    po = ParseOptions("nnet3-latgen-faster-batch [opts] <trans-model> "
                      "<raw-nnet3> <fst> <feats-rspec> <lat-wspec>")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("batch-size", int, 8, "utterances per device batch")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    _cfg, net = _load_tdnn(args[1], 3, device)
    HCLG = _load_hclg(args[2])
    # score all utterances first (the nnet stage)
    t0 = time.perf_counter()
    with torch.no_grad():
        lls = [(k, net(torch.as_tensor(np.asarray(m, np.float32))
                       .to(device)[None])[0])
               for k, m in SequentialTableReader(args[3], holder="mat")]
    _sync(device)
    nnet_s = time.perf_counter() - t0
    frames = sum(int(ll.shape[0]) for _k, ll in lls)
    t0 = time.perf_counter()
    if HCLG.num_states <= DENSE_LIMIT:
        dec = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, po["beam"],
                             po["lattice-beam"], po["acoustic-scale"],
                             max_active=po["max-active"], device=device)
        with TableWriter(args[4], holder="clat") as w:
            for k, ll in lls:
                w[k] = dec.decode_to_clat(ll)
        log.info("nnet3-latgen-faster-batch: %d utts (dense path), %d "
                 "frames, nnet %.3f s, decode %.3f s", len(lls), frames,
                 nnet_s, time.perf_counter() - t0)
        return 0
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.fst.csr import pack_fst
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    cap = max(po["max-active"], 512)
    dec = BeamDecoder(pack_fst(HCLG), tm.tid_to_pdf_array,
                      BeamDecoderConfig(
        beam=po["beam"], lattice_beam=po["lattice-beam"],
        acoustic_scale=po["acoustic-scale"],
        max_active=po["max-active"],
        lattice_arcs_per_frame=max(2 * cap, 4096)), device=device)
    setup_s = time.perf_counter() - t0      # the graph's upload
    decode_s = 0.0
    B = max(1, po["batch-size"])
    n = 0
    with TableWriter(args[4], holder="clat") as w:
        for i in range(0, len(lls), B):
            t0 = time.perf_counter()
            chunk = lls[i:i + B]
            lens = np.array([ll.shape[0] for _k, ll in chunk], np.int64)
            X = torch.zeros((len(chunk), int(lens.max()),
                             chunk[0][1].shape[1]), dtype=torch.float32,
                            device=device)
            for b, (_k, ll) in enumerate(chunk):
                X[b, :len(ll)] = ll
            raws = dec.decode_lattice_batch(X, lens)
            clats = [determinize_lattice_pruned(raw, po["lattice-beam"])
                     for raw in raws]
            decode_s += time.perf_counter() - t0
            for (k, _ll), clat in zip(chunk, clats):
                w[k] = clat
                n += 1
    log.info("nnet3-latgen-faster-batch: %d utts (batched beam path), %d "
             "frames, nnet %.3f s, graph %.3f s, decode %.3f s", n, frames,
             nnet_s, setup_s, decode_s)
    return 0
