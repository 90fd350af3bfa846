"""Port of kaldi_tpu/cli/tools_bank30.py online2-wav-nnet3-latgen-grammar
(parity target online2bin/online2-wav-nnet3-latgen-grammar.cc),
registered in cli/tools.py's ``TOOLS``: the grammar is spliced on the
host (fst/grammar.py), then the port's online2-wav-nnet3-latgen-faster
(cli/online2.py) streams on the expanded graph on ``--device`` (default
cuda: the fbank kernel, the TDNN-F and the decoder there).

The legacy online family (onlinebin/online-wav-gmm-decode-faster,
online-gmm-decode-faster, online-server-gmm-decode-faster (UDP),
online-net-client, online-audio-server-decode-faster (TCP),
online-audio-client) streams waveforms through online MFCC + Δ+ΔΔ (the
fbank kernel, a launch a chunk), the GMM kernel and a
``SingleUtteranceDecoder`` on ``--device``; the TCP server serves a
thread a connection (cli/online2.py ``serve_connections``), the clients
are the original's host code, copied.  online2-wav-nnet3-latgen-
incremental and online2-wav-nnet3-wake-word-decoder-faster stream
through ``NnetStream`` (cli/online2.py) into ``OnlineBeamDecoder`` and
``SingleUtteranceDecoder`` there.  The original's broad excepts around
a partial's traceback are ported to intent: only the decoder's
``KaldiError`` (no path yet) is passed over.  The portaudio microphone
input of the original is replaced by raw-S16LE streams (stdin, sockets,
wav tables), as in the JAX package.

The online2-wav-nnet2 tools (latgen-faster, latgen-threaded,
am-compute) stream through the same ``NnetStream`` with the nnet2
model's splice as its left and right context and no subsampling: each
chunk forwards only its new frames with that context, so the rows equal
the offline forward, as the original's docstring promises (the
original's pump forwarded every frame received so far at each chunk,
O(T²/chunk) rows).  The decodes advance a ``SingleUtteranceDecoder``
after each chunk and subtract the model's log-priors when it has them,
as the original does; the threaded variant's threads share the card,
the model, the MFCC computer (its launch count under the fbank
wrapper's lock) and the dense decoder's tables (each stream's decoder
reads them only).
"""

from __future__ import annotations

import socket
from typing import Dict, List, Tuple

import numpy as np
import torch

from kaldi_tpu_torch.cli.online2 import online_mfcc
from kaldi_tpu_torch.cli.tools import _device_po, tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.device import resolve_device

log = get_logger(__name__)


# Port of kaldi_tpu/cli/tools_bank30.py online2_wav_nnet3_latgen_grammar_tool.
@tool("online2-wav-nnet3-latgen-grammar")
def online2_wav_nnet3_latgen_grammar_tool(argv):
    """Streaming nnet3 decode over a grammar FST
    (online2bin/online2-wav-nnet3-latgen-grammar.cc): nonterminal
    sub-HCLGs are spliced in offline, then the standard streaming
    flow runs on the expanded graph."""
    import tempfile
    from kaldi_tpu_torch.cli.online2 import online2_wav_nnet3_latgen_faster
    from kaldi_tpu_torch.cli.tools_bank24 import read_grammar
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    po = ParseOptions("online2-wav-nnet3-latgen-grammar [opts] "
                      "<trans-model> <raw-nnet3> <top-hclg> "
                      "<nonterm-int1> <sub-hclg1> [...] <wav-rspec> "
                      "<words-wspec>\n(passes residual options to "
                      "online2-wav-nnet3-latgen-faster)")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("num-ceps", int, 13, "MFCC cepstra")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    if len(args) < 7 or (len(args) - 5) % 2:
        raise KaldiError("online2-wav-nnet3-latgen-grammar: need "
                         "trans-model, nnet, top, (nonterm, sub)+, "
                         "wav, words")
    resolve_device(po["device"])
    top, subs = read_grammar(args[2], args[3:-2])
    expanded = csr_to_vector_fst(replace_nonterminals(top, subs))
    with tempfile.TemporaryDirectory() as td:
        fst_path = f"{td}/expanded.fst"
        write_fst_path(fst_path, expanded)
        fwd_args = [f"--beam={po['beam']}",
                    f"--acoustic-scale={po['acoustic-scale']}",
                    "--frame-subsampling-factor="
                    f"{po['frame-subsampling-factor']}",
                    f"--num-ceps={po['num-ceps']}",
                    f"--device={po['device']}"]
        if po["word-symbol-table"]:
            fwd_args.append(
                f"--word-symbol-table={po['word-symbol-table']}")
        return online2_wav_nnet3_latgen_faster(
            fwd_args + [args[0], args[1], fst_path, args[-2],
                        args[-1]])


# ---------------------------------------------------------------------------
# shared GMM streaming core (the OnlineFasterDecoder role)
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank30.py _gmm_online_setup.
def _gmm_online_setup(mdl_path: str, fst_path: str, beam: float,
                      acoustic_scale: float, device):
    """(transition model, AmDiagGmm, DenseDecoder) on ``device``."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    tm, am = read_mdl(mdl_path, device=device)
    dec = DenseDecoder(_load_hclg(fst_path), tm.tid_to_pdf_array,
                       DenseDecoderConfig(
                           beam=beam, acoustic_scale=acoustic_scale),
                       device=device)
    return tm, am, dec


# Port of kaldi_tpu/cli/tools_bank30.py _gmm_stream.
def _gmm_stream(am, dec, mfcc, wave, chunk: int, deltas: bool = True,
                partial_cb=None, endpointing: bool = False
                ) -> Tuple[List[int], List[int]]:
    """Feed the waveform chunk-by-chunk through online MFCC(+deltas)
    (``mfcc``: the fbank kernel, a launch a chunk) → GMM (the GMM
    kernel) → SingleUtteranceDecoder.  Returns (olabels, tids); calls
    partial_cb(olabels) after each chunk when given.  With
    ``endpointing`` the decode stops at the first chunk after which the
    decoder detects an endpoint, and the rest of the input is not
    decoded (online2-wav-gmm-latgen-faster --do-endpointing).  Ported to
    intent:
    the original dropped any exception of the partial's traceback or of
    ``partial_cb``; here only the decoder's ``KaldiError`` (no path yet)
    is passed over."""
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    from kaldi_tpu_torch.features.functions import DeltaFeaturesOptions
    from kaldi_tpu_torch.features.online import OnlineFeaturePipeline
    pipe = OnlineFeaturePipeline(
        mfcc, deltas=DeltaFeaturesOptions() if deltas else None)
    online = SingleUtteranceDecoder(dec)
    fed = 0

    def pump(final: bool):
        nonlocal fed
        if final:
            pipe.input_finished()
        ready = pipe.num_frames_ready()
        if ready > fed:
            online.advance_decoding(am.loglikes(pipe.get_frames(fed,
                                                                ready)))
            fed = ready

    for i in range(0, len(wave), chunk):
        pipe.accept_waveform(np.asarray(wave[i:i + chunk], np.float32))
        pump(False)
        if endpointing and online.endpoint_detected():
            break
        if partial_cb is not None and fed > 0:
            try:
                _t, ols, _c = online.get_best_path(use_final_probs=False)
            except KaldiError:
                continue                # no path yet
            partial_cb(ols)
    else:
        pump(True)
    tids, ols, _cost = online.get_best_path(use_final_probs=True)
    return ols, tids


# ---------------------------------------------------------------------------
# onlinebin (legacy online family)
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank30.py online_wav_gmm_decode_faster_tool.
@tool("online-wav-gmm-decode-faster")
def online_wav_gmm_decode_faster_tool(argv):
    """Legacy streaming GMM decode over a wav table
    (onlinebin/online-wav-gmm-decode-faster.cc): words + alignments
    out, partial hypotheses logged as they form."""
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("online-wav-gmm-decode-faster [opts] <model> "
                      "<fst> <wav-rspec> <words-wspec> [<ali-wspec>]")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("chunk-length", float, 0.18, "seconds per chunk")
    po.register("word-symbol-table", str, "", "words.txt")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, am, dec = _gmm_online_setup(args[0], args[1], po["beam"],
                                     po["acoustic-scale"], device)
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    awriter = (TableWriter(args[4], holder="ivec")
               if len(args) > 4 else None)
    computers = {}
    n = 0
    with TableWriter(args[3], holder="text") as w:
        for key, (wave, rate) in SequentialTableReader(args[2],
                                                       holder="wav"):
            if rate not in computers:
                computers[rate] = online_mfcc(rate, device)
            chunk = max(1, int(po["chunk-length"] * rate))
            ols, tids = _gmm_stream(am, dec, computers[rate], wave, chunk)
            w[key] = [words_tab.find(o) if words_tab else str(o)
                      for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("online-wav-gmm-decode-faster: %d utterances; fbank kernel "
             "launches %d, GMM kernel launches %d", n,
             sum(c.kernel.launches for c in computers.values()),
             am.device_params().launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank30.py online_gmm_decode_faster_tool.
@tool("online-gmm-decode-faster")
def online_gmm_decode_faster_tool(argv):
    """Legacy 'microphone' streaming GMM decode
    (onlinebin/online-gmm-decode-faster.cc): raw S16LE PCM from stdin
    (or --audio=<file>) stands in for the portaudio capture; partial
    hypotheses print as they form, the final line at end-of-stream."""
    import sys
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("online-gmm-decode-faster [opts] <model> <fst> "
                      "<words.txt>")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("samp-freq", float, 16000.0, "input sample rate")
    po.register("chunk-length", float, 0.18, "seconds per chunk")
    po.register("audio", str, "",
                "raw S16LE file standing in for the microphone "
                "(default: stdin)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, am, dec = _gmm_online_setup(args[0], args[1], po["beam"],
                                     po["acoustic-scale"], device)
    words_tab = SymbolTable.read(args[2])
    if po["audio"]:
        with open(po["audio"], "rb") as f:
            raw = f.read()
    else:
        raw = sys.stdin.buffer.read()
    wave = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    chunk = max(1, int(po["chunk-length"] * po["samp-freq"]))

    def partial(ols):
        print("partial: " + " ".join(words_tab.find(o) for o in ols))

    ols, _tids = _gmm_stream(am, dec, online_mfcc(po["samp-freq"], device),
                             wave, chunk, partial_cb=partial)
    print(" ".join(words_tab.find(o) for o in ols))
    log.info("online-gmm-decode-faster: %d samples decoded",
             len(wave))
    return 0


# Port of kaldi_tpu/cli/tools_bank30.py online_server_gmm_decode_faster_tool.
@tool("online-server-gmm-decode-faster")
def online_server_gmm_decode_faster_tool(argv):
    """Legacy UDP decoding server
    (onlinebin/online-server-gmm-decode-faster.cc): clients send raw
    S16LE PCM datagrams (an empty datagram ends the utterance); the
    server replies to the sender with the hypothesis.  It logs the bound
    port (``--udp-port=0``: the system's choice)."""
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("online-server-gmm-decode-faster [opts] <model> "
                      "<fst> <words.txt>")
    po.register("udp-port", int, 5051, "listen port")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("samp-freq", float, 16000.0, "input sample rate")
    po.register("max-utterances", int, 0,
                "serve this many utterances then exit (0 = forever)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, am, dec = _gmm_online_setup(args[0], args[1], po["beam"],
                                     po["acoustic-scale"], device)
    words_tab = SymbolTable.read(args[2])
    mfcc = online_mfcc(po["samp-freq"], device)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", po["udp-port"]))
    sock.settimeout(30.0)
    log.info("online-server-gmm-decode-faster: listening on udp:%d",
             sock.getsockname()[1])
    served = 0
    buf: Dict[Tuple[str, int], bytes] = {}
    try:
        while not po["max-utterances"] or served < po["max-utterances"]:
            try:
                data, addr = sock.recvfrom(65536)
            except socket.timeout:
                break
            if data:
                buf[addr] = buf.get(addr, b"") + data
                continue
            # empty datagram = end of utterance
            wave = np.frombuffer(buf.pop(addr, b""),
                                 dtype="<i2").astype(np.float32)
            chunk = max(1, int(0.18 * po["samp-freq"]))
            ols, _tids = _gmm_stream(am, dec, mfcc, wave, chunk)
            text = " ".join(words_tab.find(o) for o in ols)
            sock.sendto(text.encode() + b"\n", addr)
            served += 1
            log.info("served %s: %s", addr, text)
    finally:
        sock.close()
    log.info("online-server-gmm-decode-faster: %d utterances; fbank "
             "kernel launches %d, GMM kernel launches %d", served,
             mfcc.kernel.launches, am.device_params().launches)
    return 0


# Copied from kaldi_tpu/cli/tools_bank30.py online_net_client_tool.
@tool("online-net-client")
def online_net_client_tool(argv):
    """Legacy UDP client (onlinebin/online-net-client.cc): streams a
    wav table's audio to online-server-gmm-decode-faster and prints
    the hypotheses."""
    from kaldi_tpu_torch.core.table import SequentialTableReader
    po = ParseOptions("online-net-client <server-host> <server-port> "
                      "<wav-rspec>")
    po.register("packet-size", int, 4096, "bytes per datagram")
    args = po.read(argv)
    host, port = args[0], int(args[1])
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(60.0)
    n = 0
    try:
        for key, (wave, _rate) in SequentialTableReader(args[2],
                                                        holder="wav"):
            data = np.asarray(wave, np.int16).tobytes()
            for i in range(0, len(data), po["packet-size"]):
                sock.sendto(data[i:i + po["packet-size"]],
                            (host, port))
            sock.sendto(b"", (host, port))          # end marker
            reply, _addr = sock.recvfrom(65536)
            print(f"{key} {reply.decode().strip()}")
            n += 1
    finally:
        sock.close()
    log.info("online-net-client: %d utterances", n)
    return 0


# Port of kaldi_tpu/cli/tools_bank30.py
# online_audio_server_decode_faster_tool.
@tool("online-audio-server-decode-faster")
def online_audio_server_decode_faster_tool(argv):
    """Legacy TCP audio server
    (onlinebin/online-audio-server-decode-faster.cc): one raw-S16LE
    audio stream per connection; replies with 'RESULT:' + hypothesis
    and per-word 'WORD:' lines, then closes.  Connections are served on
    threads that share the model, the decoder's graph and the MFCC
    computer on ``--device``; a failure of one ends the serving and the
    tool exits non-zero.  A client that resets its connection ends only
    that connection."""
    import torch
    from kaldi_tpu_torch.cli.online2 import serve_connections
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("online-audio-server-decode-faster [opts] "
                      "<model> <fst> <words.txt>")
    po.register("port-num", int, 5052, "listen port")
    po.register("beam", float, 16.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("samp-freq", float, 16000.0, "input sample rate")
    po.register("max-connections", int, 0,
                "serve this many connections then exit (0 = forever)")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, am, dec = _gmm_online_setup(args[0], args[1], po["beam"],
                                     po["acoustic-scale"], device)
    words_tab = SymbolTable.read(args[2])
    rate = po["samp-freq"]
    mfcc = online_mfcc(rate, device)

    def handle(sock, addr):
        sock.settimeout(30.0)
        raw = b""
        while True:
            try:
                data = sock.recv(8192)
            except socket.timeout:
                break
            except ConnectionError:
                log.info("audio client %s: connection reset", addr)
                return                  # the client is gone
            if not data:
                break
            raw += data
        wave = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        if len(wave) < 400:           # not even one frame
            reply = b"RESULT:\n"
        else:
            with torch.inference_mode():
                ols, _tids = _gmm_stream(am, dec, mfcc, wave,
                                         max(1, int(0.18 * rate)))
            text = " ".join(words_tab.find(o) for o in ols)
            out = [f"RESULT:{text}"]
            for o in ols:
                out.append(f"WORD:{words_tab.find(o)}")
            reply = ("\n".join(out) + "\n").encode()
        try:
            sock.sendall(reply)
        except ConnectionError:
            log.info("audio client %s: connection reset", addr)

    serve_connections(
        handle, "127.0.0.1", po["port-num"], po["max-connections"],
        on_listen=lambda p: log.info(
            "online-audio-server-decode-faster: listening on %d", p))
    log.info("online-audio-server-decode-faster: fbank kernel launches "
             "%d, GMM kernel launches %d", mfcc.kernel.launches,
             am.device_params().launches)
    return 0


# Copied from kaldi_tpu/cli/tools_bank30.py online_audio_client_tool.
@tool("online-audio-client")
def online_audio_client_tool(argv):
    """Legacy TCP audio client (onlinebin/online-audio-client.cc):
    sends a wav table's audio to online-audio-server-decode-faster
    and prints each reply."""
    from kaldi_tpu_torch.core.table import SequentialTableReader
    po = ParseOptions("online-audio-client <server-host> "
                      "<server-port> <wav-rspec>")
    args = po.read(argv)
    host, port = args[0], int(args[1])
    n = 0
    for key, (wave, _rate) in SequentialTableReader(args[2],
                                                    holder="wav"):
        with socket.create_connection((host, port),
                                      timeout=60) as sock:
            sock.sendall(np.asarray(wave, np.int16).tobytes())
            sock.shutdown(socket.SHUT_WR)
            sock.settimeout(120.0)
            got = b""
            while True:
                data = sock.recv(65536)
                if not data:
                    break
                got += data
        for line in got.decode().splitlines():
            print(f"{key} {line}")
        n += 1
    log.info("online-audio-client: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# online2bin: incremental and wake-word nnet3 streaming
# ---------------------------------------------------------------------------

# Port of kaldi_tpu/cli/tools_bank30.py
# online2_wav_nnet3_latgen_incremental_tool.
@tool("online2-wav-nnet3-latgen-incremental")
def online2_wav_nnet3_latgen_incremental_tool(argv):
    """Streaming nnet3 decode with INCREMENTAL lattice output
    (online2bin/online2-wav-nnet3-latgen-incremental.cc): the
    large-graph streaming decoder runs every utterance and the
    determinized CompactLattice is produced from the streamed state —
    bounded memory regardless of utterance length.  MFCC (the fbank
    kernel), the TDNN-F's chunks and the decoder run on ``--device``."""
    import torch
    from kaldi_tpu_torch.cli.online2 import NnetStream, _load_tdnn
    from kaldi_tpu_torch.cli.tools_bank31 import incremental_decoder
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    po = ParseOptions("online2-wav-nnet3-latgen-incremental [opts] "
                      "<trans-model> <raw-nnet3> <fst> <wav-rspec> "
                      "<lattice-wspec>")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("chunk-length", float, 0.18, "seconds per chunk")
    po.register("sample-frequency", float, 16000.0, "expected rate")
    po.register("num-ceps", int, 13, "MFCC cepstra")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    _tm, ob = incremental_decoder(args[0], args[2], po, device,
                                  record_capacity=65536)
    sub = po["frame-subsampling-factor"]
    _, net = _load_tdnn(args[1], sub, device)
    rate = po["sample-frequency"]
    chunk = max(1, int(po["chunk-length"] * rate))
    mfcc = online_mfcc(po["sample-frequency"], device, po["num-ceps"])
    n = 0
    with TableWriter(args[4], holder="clat") as w, torch.no_grad():
        for key, (wave, wrate) in SequentialTableReader(args[3],
                                                        holder="wav"):
            if wrate != rate:
                raise KaldiError(f"{key}: rate {wrate} != {rate}")
            stream = NnetStream(mfcc, net, sub, device)
            ob.reset()
            for i in range(0, len(wave), chunk):
                stream.accept_waveform(wave[i:i + chunk])
                scores = stream.pump(False)
                if scores.numel():
                    ob.advance(scores)
            scores = stream.pump(True)
            if scores.numel():
                ob.advance(scores)
            w[key] = ob.finalize()
            n += 1
    log.info("online2-wav-nnet3-latgen-incremental: %d utterances; fbank "
             "kernel launches %d", n, mfcc.kernel.launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank30.py
# online2_wav_nnet3_wake_word_decoder_faster_tool.
@tool("online2-wav-nnet3-wake-word-decoder-faster")
def online2_wav_nnet3_wake_word_decoder_faster_tool(argv):
    """Streaming wake-word detection
    (online2bin/online2-wav-nnet3-wake-word-decoder-faster.cc): the
    partial best path is checked after every chunk; the first chunk
    whose hypothesis contains the wake word ends decoding.  Output:
    '<detected 0|1> <frame>' per utterance.  Ported to intent: the
    original passed over any exception of a chunk's partial traceback;
    here only the decoder's ``KaldiError`` (no path yet) is."""
    import torch
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.cli.online2 import NnetStream, _load_tdnn
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    po = ParseOptions("online2-wav-nnet3-wake-word-decoder-faster "
                      "[opts] <trans-model> <raw-nnet3> <fst> "
                      "<wake-word-int> <wav-rspec> <result-wspec>")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("chunk-length", float, 0.18, "seconds per chunk")
    po.register("sample-frequency", float, 16000.0, "expected rate")
    po.register("num-ceps", int, 13, "MFCC cepstra")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    sub = po["frame-subsampling-factor"]
    _, net = _load_tdnn(args[1], sub, device)
    dec = DenseDecoder(_load_hclg(args[2]), tm.tid_to_pdf_array,
                       DenseDecoderConfig(
                           beam=po["beam"],
                           acoustic_scale=po["acoustic-scale"]),
                       device=device)
    wake = int(args[3])
    rate = po["sample-frequency"]
    chunk = max(1, int(po["chunk-length"] * rate))
    mfcc = online_mfcc(po["sample-frequency"], device, po["num-ceps"])
    n = n_det = 0
    with TableWriter(args[5], holder="text") as w, torch.no_grad():
        for key, (wave, wrate) in SequentialTableReader(args[4],
                                                        holder="wav"):
            if wrate != rate:
                raise KaldiError(f"{key}: rate {wrate} != {rate}")
            stream = NnetStream(mfcc, net, sub, device)
            online = SingleUtteranceDecoder(dec)
            hit_frame = -1
            for i in range(0, len(wave), chunk):
                stream.accept_waveform(wave[i:i + chunk])
                scores = stream.pump(False)
                if scores.numel():
                    online.advance_decoding(scores)
                if online.num_frames_decoded > 0:
                    try:
                        _t, ols, _c = online.get_best_path(
                            use_final_probs=False)
                    except KaldiError:
                        continue        # no path yet
                    if wake in ols:
                        hit_frame = online.num_frames_decoded
                        break
            else:
                scores = stream.pump(True)
                if scores.numel():
                    online.advance_decoding(scores)
                if online.num_frames_decoded > 0:
                    _t, ols, _c = online.get_best_path(
                        use_final_probs=True)
                    if wake in ols:
                        hit_frame = online.num_frames_decoded
            w[key] = [str(int(hit_frame >= 0)), str(hit_frame)]
            n += 1
            n_det += int(hit_frame >= 0)
    log.info("online2-wav-nnet3-wake-word-decoder-faster: %d/%d "
             "detections; fbank kernel launches %d", n_det, n,
             mfcc.kernel.launches)
    return 0


# ---------------------------------------------------------------------------
# online2bin: nnet2 streaming
# ---------------------------------------------------------------------------

def nnet2_stream(mfcc, model, wave, chunk: int, device, on_scores) -> None:
    """One waveform in ``chunk``-sample pieces → online MFCC → the nnet2
    ``model``'s rows as they become final (``NnetStream`` with the
    model's splice as context, no subsampling), each batch of new rows
    handed to ``on_scores``."""
    from kaldi_tpu_torch.cli.online2 import NnetStream
    splice = model.config.splice
    ctx = max(-min(splice), max(splice), 0)
    st = NnetStream(mfcc, model, 1, device, left_context=ctx,
                    right_context=ctx)
    wave = np.asarray(wave, np.float32)
    with torch.no_grad():
        for i in range(0, len(wave), chunk):
            st.accept_waveform(wave[i:i + chunk])
            s = st.pump(False)
            if s.numel():
                on_scores(s)
        s = st.pump(True)
        if s.numel():
            on_scores(s)


def _online2_nnet2_po(name: str, usage: str) -> ParseOptions:
    po = ParseOptions(f"{name} [opts] {usage}")
    po.register("chunk-length", float, 0.18, "seconds per chunk")
    po.register("sample-frequency", float, 16000.0, "expected rate")
    po.register("num-ceps", int, 13, "MFCC cepstra (model input dim)")
    _device_po(po)
    return po


def _online2_nnet2_decode(argv, name: str, threaded: bool):
    from kaldi_tpu_torch.cli.tools_bank19 import (latgen_inputs,
                                                  load_nnet2_scorer)
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = _online2_nnet2_po(name, "<trans-model> <nnet2-in> <fst> "
                           "<wav-rspec> <words-wspec>")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt")
    po.register("num-threads", int, 4,
                "worker threads (threaded variant)")
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, HCLG = latgen_inputs(args[0], args[2])
    model, _cfg, logpri = load_nnet2_scorer(args[1], device)
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                       DenseDecoderConfig(
                           beam=po["beam"],
                           acoustic_scale=po["acoustic-scale"]),
                       device=device)
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    rate = po["sample-frequency"]
    chunk = max(1, int(po["chunk-length"] * rate))
    mfcc = online_mfcc(rate, device, po["num-ceps"])

    def one(item):
        key, (wave, wrate) = item
        if wrate != rate:
            raise KaldiError(f"{key}: rate {wrate} != {rate}")
        online = SingleUtteranceDecoder(dec)
        nnet2_stream(mfcc, model, wave, chunk, device,
                     lambda s: online.advance_decoding(
                         s if logpri is None else s - logpri))
        _t, ols, _c = online.get_best_path(use_final_probs=True)
        return key, [words_tab.find(o) if words_tab else str(o)
                     for o in ols]

    entries = list(SequentialTableReader(args[3], holder="wav"))
    if threaded:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=po["num-threads"]) as pool:
            results = list(pool.map(one, entries))
    else:
        results = [one(e) for e in entries]
    with TableWriter(args[4], holder="text") as w:
        for key, text in results:
            w[key] = text
    log.info("%s: %d utterances; fbank kernel launches %d", name,
             len(results), mfcc.kernel.launches)
    return 0


# Port of kaldi_tpu/cli/tools_bank30.py online2_wav_nnet2_latgen_faster_tool.
@tool("online2-wav-nnet2-latgen-faster")
def online2_wav_nnet2_latgen_faster_tool(argv):
    """Streaming nnet2 decode
    (online2bin/online2-wav-nnet2-latgen-faster.cc) on ``--device``."""
    return _online2_nnet2_decode(argv,
                                 "online2-wav-nnet2-latgen-faster",
                                 threaded=False)


# Port of kaldi_tpu/cli/tools_bank30.py
# online2_wav_nnet2_latgen_threaded_tool.
@tool("online2-wav-nnet2-latgen-threaded")
def online2_wav_nnet2_latgen_threaded_tool(argv):
    """Threaded streaming nnet2 decode
    (online2bin/online2-wav-nnet2-latgen-threaded.cc): ``--num-threads``
    utterances at once on ``--device``."""
    return _online2_nnet2_decode(argv,
                                 "online2-wav-nnet2-latgen-threaded",
                                 threaded=True)


# Port of kaldi_tpu/cli/tools_bank30.py online2_wav_nnet2_am_compute_tool.
@tool("online2-wav-nnet2-am-compute")
def online2_wav_nnet2_am_compute_tool(argv):
    """Streaming nnet2 forward: wav chunks → online MFCC → the model's
    new rows a chunk; outputs equal the offline forward
    (online2bin/online2-wav-nnet2-am-compute.cc), on ``--device``."""
    from kaldi_tpu_torch.cli.tools_bank19 import load_nnet2_scorer
    from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
    po = _online2_nnet2_po("online2-wav-nnet2-am-compute",
                           "<nnet2-in> <wav-rspec> <mat-wspec>")
    args = po.read(argv)
    device = resolve_device(po["device"])
    model, cfg, _ = load_nnet2_scorer(args[0], device,
                                      divide_by_priors=False)
    rate = po["sample-frequency"]
    chunk = max(1, int(po["chunk-length"] * rate))
    mfcc = online_mfcc(rate, device, po["num-ceps"])
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, (wave, wrate) in SequentialTableReader(args[1],
                                                        holder="wav"):
            if wrate != rate:
                raise KaldiError(f"{key}: rate {wrate} != {rate}")
            rows = []
            nnet2_stream(mfcc, model, wave, chunk, device, rows.append)
            w[key] = (torch.cat(rows).cpu().numpy() if rows
                      else np.zeros((0, cfg.num_pdfs), np.float32))
            n += 1
    log.info("online2-wav-nnet2-am-compute: %d utterances; fbank kernel "
             "launches %d", n, mfcc.kernel.launches)
    return 0
