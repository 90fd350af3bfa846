"""online2-wav-nnet3-latgen-faster: streaming nnet3 decoding of waveforms.

Port of the tool of kaldi_tpu/cli/tools_bank7.py and of ``_load_tdnn``
(kaldi_tpu/cli/tools_bank3.py; parity target
online2bin/online2-wav-nnet3-latgen-faster.cc).  Each waveform goes in
``--chunk-length`` pieces through online MFCC (the fbank kernel on a
CUDA device), context-buffered TDNN-F scoring (``OnlineNnetScorer``) and
a streaming decoder: ``OnlineBeamDecoder`` above 20,000 graph states,
``SingleUtteranceDecoder`` on the dense decoder otherwise, as in the
original.  With ``--ivector-extractor`` each utterance gets a fresh
``OnlineIvectorEstimator`` (am/ivector.py, float64 on the device) and
the features carry its online i-vector (re-estimated every
``--ivector-period`` frames).  The best path's words are written per
utterance.  The options are the original's, plus ``--device`` (default
cuda).

    python -m kaldi_tpu_torch.cli.online2 [opts] <trans-model> \\
        <raw-nnet3> <fst> <wav-rspec> <words-wspec>

The module also holds what the other online2 tools share: ``NnetStream``
(one utterance's MFCC → TDNN-F scoring pump) and ``serve_connections``
(the TCP servers' threaded serving, whose handlers' failures end the
tool).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank3.py _load_tdnn.
def _load_tdnn(path: str, subsample: int,
               device: torch.device | str = "cuda"):
    """A binary nnet3 ``.raw`` TDNN-F → (TdnnConfig, TdnnChain in eval
    mode on ``device``)."""
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    from kaldi_tpu_torch.am.tdnn import TdnnChain
    device = resolve_device(device)
    model = read_nnet3_path(path)
    cfg = infer_tdnn_config(model, frame_subsampling_factor=subsample)
    net = TdnnChain(cfg)
    net.load_state_dict(nnet3_to_state_dict(model, cfg))
    return cfg, net.eval().to(device)


def online_mfcc(rate: float, device, num_ceps: int = 13):
    """The online tools' MFCC (online2's and the legacy GMM tools'):
    ``num_ceps`` cepstra at ``rate``, no dither, on ``device``; one
    computer serves every utterance and thread."""
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    return Mfcc(MfccOptions(
        frame_opts=FrameExtractionOptions(samp_freq=float(rate), dither=0.0),
        num_ceps=num_ceps), device=device)


class NnetStream:
    """One utterance's online2 front end: waveform chunks → online MFCC
    (``mfcc``; the fbank kernel on a card), with the online i-vector of
    ``ivector_estimator`` appended when given (re-estimated every
    ``ivector_period`` frames) → context-buffered network scores
    (``OnlineNnetScorer`` with ``left_context`` / ``right_context``
    frames around each chunk: a TDNN-F's, or an nnet2 model's splice at
    ``subsample`` 1).  The pump of the original's online2 tools
    (online2-wav-nnet3-latgen-faster, -incremental, the wake-word
    decoder, the TCP server, the online2-wav-nnet2 tools), shared; each
    stream owns its pipeline, estimator and scorer, so streams on
    threads share only ``mfcc`` and ``net``."""

    def __init__(self, mfcc, net, subsample: int,
                 device: torch.device | str = "cuda",
                 ivector_estimator=None, ivector_period: int = 10,
                 left_context: int = 24, right_context: int = 24):
        from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer
        from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
        self.pipe = OnlineFeaturePipeline(
            mfcc, ivector_estimator=ivector_estimator,
            ivector_period=ivector_period)
        self.scorer = OnlineNnetScorer(net, left_context=left_context,
                                       right_context=right_context,
                                       subsample=subsample, device=device)
        self.fed = 0

    def accept_waveform(self, samples) -> None:
        self.pipe.accept_waveform(np.asarray(samples, np.float32))

    def pump(self, final: bool) -> torch.Tensor:
        """Features ready so far into the scorer (with ``final``, the
        input's end) → the new score rows, (0, 0) when none."""
        if final:
            self.pipe.input_finished()
        ready = self.pipe.num_frames_ready()
        if ready > self.fed:
            self.scorer.accept_features(self.pipe.get_frames(self.fed,
                                                             ready))
            self.fed = ready
        if final:
            self.scorer.input_finished()
        return self.scorer.read_new()


def serve_connections(handle, host: str, port: int,
                      max_connections: int, on_listen=None) -> None:
    """Serve TCP connections, one thread each
    (``socketserver.ThreadingTCPServer``, as the original's servers):
    ``handle(sock, address)`` per connection, until ``max_connections``
    have been handled (0: forever).  ``on_listen(port)`` gets the bound
    port.  A handler's exception ends its connection and the serving: it
    is raised here once the server has stopped, so the tool exits
    non-zero (the original's handlers lost it in the server's thread)."""
    import socketserver
    import threading
    state = {"served": 0, "error": None}
    cond = threading.Condition()

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            err = None
            try:
                handle(self.request, self.client_address)
            except BaseException as e:      # raised again by the server
                err = e
            with cond:
                state["served"] += 1
                if err is not None and state["error"] is None:
                    state["error"] = err
                cond.notify_all()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        if on_listen is not None:
            on_listen(srv.server_address[1])
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        with cond:
            cond.wait_for(lambda: state["error"] is not None or (
                0 < max_connections <= state["served"]))
        srv.shutdown()
        t.join()
    if state["error"] is not None:
        raise state["error"]


def online2_wav_nnet3_latgen_faster(argv=None) -> int:
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import (_load_hclg, latgen_kwargs,
                                            register_latgen_opts)
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    po = ParseOptions(
        "online2-wav-nnet3-latgen-faster [opts] <trans-model> "
        "<raw-nnet3> <fst> <wav-rspec> <words-wspec>")
    po.register("chunk-length", float, 0.18, "seconds per audio chunk")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("sample-frequency", float, 16000.0, "expected rate")
    po.register("num-ceps", int, 13, "MFCC cepstra (model input dim)")
    po.register("word-symbol-table", str, "", "words.txt")
    po.register("ivector-extractor", str, "",
                "online i-vectors appended to features (the "
                "OnlineIvectorFeature role)")
    po.register("ivector-period", int, 10,
                "re-estimate the i-vector every N frames")
    po.register("do-endpointing", bool, False,
                "stop decoding at a detected endpoint")
    po.register("device", str, "cuda", "torch device to decode on")
    register_latgen_opts(po)
    args = po.read(argv)
    if len(args) != 5:
        po.print_usage()
        return 1
    device = resolve_device(po["device"])
    extractor = None
    if po["ivector-extractor"]:
        from kaldi_tpu_torch.am.ivector import read_ivector_extractor
        extractor = read_ivector_extractor(po["ivector-extractor"],
                                           device=device)
    tm, _ = read_mdl(args[0], device=device)
    _, net = _load_tdnn(args[1], po["frame-subsampling-factor"], device)
    HCLG = _load_hclg(args[2])
    if HCLG.num_states > 20000:
        # large-graph streaming path (OnlineBeamDecoder)
        from kaldi_tpu_torch.decoder.beam import (BeamDecoder,
                                                  BeamDecoderConfig)
        from kaldi_tpu_torch.decoder.online_beam import OnlineBeamDecoder
        from kaldi_tpu_torch.fst.csr import pack_fst
        kw = latgen_kwargs(po)
        dec = BeamDecoder(pack_fst(HCLG), tm.tid_to_pdf_array,
                          BeamDecoderConfig(
                              beam=po["beam"], max_active=7000,
                              acoustic_scale=po["acoustic-scale"],
                              lattice_beam=8.0,
                              lattice_arcs_per_frame=8192,
                              record_capacity=65536, **kw), device=device)
        log.info("online2: %d states → OnlineBeamDecoder "
                 "(large-graph streaming path; arc_budget %d, "
                 "escalate %d)", HCLG.num_states, kw["arc_budget"],
                 kw["escalate_budget"])
        # one decoder serves every utterance
        online_beam = OnlineBeamDecoder(dec)
    else:
        from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                                   DenseDecoderConfig)
        dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                           DenseDecoderConfig(
                               beam=po["beam"],
                               acoustic_scale=po["acoustic-scale"]),
                           device=device)
        online_beam = None
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu_torch.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    chunk = int(po["chunk-length"] * po["sample-frequency"])
    mfcc = online_mfcc(po["sample-frequency"], device, po["num-ceps"])
    n = 0
    with TableWriter(args[4], holder="text") as w:
        for key, (wave, rate) in SequentialTableReader(args[3],
                                                       holder="wav"):
            if rate != po["sample-frequency"]:
                raise KaldiError(f"{key}: rate {rate} != "
                                 f"{po['sample-frequency']}")
            est = None
            if extractor is not None:
                from kaldi_tpu_torch.am.ivector import OnlineIvectorEstimator
                est = OnlineIvectorEstimator(extractor)
            stream = NnetStream(mfcc, net, po["frame-subsampling-factor"],
                                device, ivector_estimator=est,
                                ivector_period=po["ivector-period"])
            if online_beam is None:
                online = SingleUtteranceDecoder(dec)
            else:
                online = online_beam
                online.reset()
            for i in range(0, len(wave), chunk):
                stream.accept_waveform(wave[i:i + chunk])
                scores = stream.pump(False)
                if scores.numel():
                    online.advance_decoding(scores)
                if po["do-endpointing"] and online.endpoint_detected():
                    break
            else:
                scores = stream.pump(True)
                if scores.numel():
                    online.advance_decoding(scores)
            _, ols, cost = online.get_best_path(use_final_probs=True)
            text = [words_tab.find(o) if words_tab else str(o)
                    for o in ols]
            w[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
    log.info("streamed %d utterances; fbank kernel launches %d", n,
             mfcc.kernel.launches)
    return 0


def main(argv=None) -> int:
    try:
        return online2_wav_nnet3_latgen_faster(argv)
    except KaldiError as e:
        print(f"ERROR (online2-wav-nnet3-latgen-faster): {e}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
