"""Port of kaldi_tpu/cli/tools_bank24.py make-grammar-fst (parity target
fstbin/make-grammar-fst.cc), registered in cli/tools.py's ``TOOLS``: host
code, copied (fst/grammar.py ``replace_nonterminals``).  And the online2
TCP server, online2-tcp-nnet3-decode-faster
(online2bin/online2-tcp-nnet3-decode-faster.cc), on ``--device``
(default cuda): one thread a connection, each streaming its PCM through
online MFCC (the fbank kernel, a launch a chunk), the TDNN-F and a
``SingleUtteranceDecoder`` on the shared dense decoder.
"""

from __future__ import annotations

from kaldi_tpu_torch.cli.tools import tool
from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.core.options import ParseOptions

log = get_logger(__name__)


def read_grammar(top_path: str, pairs):
    """The top graph and ``<nonterm-int> <sub>`` argument pairs (each FST
    a text or binary OpenFst file) → (top, {nonterm: sub}) as CSR graphs
    (the argument handling the original's grammar tools share)."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.fst.csr import pack_fst
    subs = {int(pairs[i]): pack_fst(_load_hclg(pairs[i + 1]))
            for i in range(0, len(pairs), 2)}
    return pack_fst(_load_hclg(top_path)), subs


# Port of kaldi_tpu/cli/tools_bank24.py make_grammar_fst_tool.
@tool("make-grammar-fst")
def make_grammar_fst_tool(argv):
    """Splice nonterminal sub-HCLGs into a top-level HCLG
    (fstbin/make-grammar-fst.cc).  The reference builds a GrammarFst
    expanded lazily at decode time; this implementation expands
    offline via fst/grammar.py replace_nonterminals — the decoder
    consumes the result like any HCLG (swap_sub supports runtime
    replacement through the library API)."""
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    po = ParseOptions("make-grammar-fst <top-hclg> <nonterm-int1> "
                      "<sub-hclg1> [<nonterm-int2> <sub-hclg2> ...] "
                      "<fst-out>")
    args = po.read(argv)
    if len(args) < 4 or len(args) % 2 != 0:
        raise KaldiError("make-grammar-fst: need top, (nonterm, sub) "
                         "pairs, out")
    top, subs = read_grammar(args[0], args[1:-1])
    expanded = replace_nonterminals(top, subs)
    write_fst_path(args[-1], csr_to_vector_fst(expanded))
    log.info("make-grammar-fst: %d nonterminals → %d states",
             len(subs), expanded.num_states)
    return 0


# Port of kaldi_tpu/cli/tools_bank24.py online2_tcp_nnet3_decode_faster_tool.
@tool("online2-tcp-nnet3-decode-faster")
def online2_tcp_nnet3_decode_faster_tool(argv):
    """TCP streaming recognition server
    (online2bin/online2-tcp-nnet3-decode-faster.cc): clients send raw
    S16LE PCM; the server streams back partial hypotheses terminated
    by '\\r' and, at end-of-stream, the final hypothesis terminated by
    '\\n' — the upstream wire protocol.  The bound port is printed on
    stdout.  --max-connections bounds the serving loop (0 = serve
    forever).  Connections are served on threads: each has its own
    feature pipeline, scorer and streaming decoder, all share the
    TDNN-F, the decoder's graph and the MFCC computer on ``--device``.
    Ported to intent: the original turned any exception of a partial's
    traceback into an empty partial and any exception of the final
    decode into an empty final; here only the decoder's ``KaldiError``
    (no path yet) is, and any other error ends the connection, the
    serving and the tool (non-zero exit).  A client that resets its
    connection ends only that connection, with no final decode."""
    import socket

    import numpy as np
    import torch

    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.cli.online2 import (NnetStream, _load_tdnn,
                                             online_mfcc, serve_connections)
    from kaldi_tpu_torch.cli.tools import _device_po
    from kaldi_tpu_torch.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    from kaldi_tpu_torch.device import resolve_device
    from kaldi_tpu_torch.fst.fst import SymbolTable
    po = ParseOptions("online2-tcp-nnet3-decode-faster [opts] "
                      "<trans-model> <raw-nnet3> <fst> <words.txt>")
    po.register("port-num", int, 5050, "listen port")
    po.register("samp-freq", float, 16000.0, "expected sample rate")
    po.register("chunk-length", float, 0.18, "seconds per decode step")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("num-ceps", int, 13, "MFCC cepstra (model input dim)")
    po.register("max-connections", int, 0,
                "serve this many connections then exit (0 = forever)")
    po.register("read-timeout", float, 10.0,
                "seconds without data before finalizing")
    _device_po(po)
    args = po.read(argv)
    device = resolve_device(po["device"])
    tm, _ = read_mdl(args[0], device="cpu")
    sub = po["frame-subsampling-factor"]
    _, net = _load_tdnn(args[1], sub, device)
    words_tab = SymbolTable.read(args[3])
    dec = DenseDecoder(_load_hclg(args[2]), tm.tid_to_pdf_array,
                       DenseDecoderConfig(
                           beam=po["beam"],
                           acoustic_scale=po["acoustic-scale"]),
                       device=device)
    rate = po["samp-freq"]
    chunk_samples = max(1, int(po["chunk-length"] * rate))
    mfcc = online_mfcc(rate, device, po["num-ceps"])

    def words(online, use_final: bool) -> str:
        try:
            _t, ols, _c = online.get_best_path(use_final_probs=use_final)
        except KaldiError:
            return ""                   # no path yet
        return " ".join(words_tab.find(o) for o in ols)

    def handle(sock, addr):
        # grad mode is per thread: each handler turns it off itself
        with torch.inference_mode():
            serve_stream(sock, addr)

    def serve_stream(sock, addr):
        sock.settimeout(po["read-timeout"])
        stream = NnetStream(mfcc, net, sub, device)
        online = SingleUtteranceDecoder(dec)
        buf = b""
        while True:
            try:
                data = sock.recv(4096)
            except socket.timeout:
                break
            except ConnectionError:
                log.info("tcp client %s: connection reset", addr)
                return                  # the client is gone
            if not data:
                break
            buf += data
            n_samp = (len(buf) // (2 * chunk_samples)) * chunk_samples
            if n_samp:
                pcm = np.frombuffer(buf[:2 * n_samp], np.int16)
                buf = buf[2 * n_samp:]
                stream.accept_waveform(pcm.astype(np.float32))
                scores = stream.pump(False)
                if scores.numel():
                    online.advance_decoding(scores)
                    try:
                        sock.sendall(
                            (words(online, False) + "\r").encode())
                    except ConnectionError:
                        log.info("tcp client %s: connection reset", addr)
                        return          # the client is gone
        if buf:
            stream.accept_waveform(np.frombuffer(
                buf[:2 * (len(buf) // 2)], np.int16).astype(np.float32))
        scores = stream.pump(True)
        if scores.numel():
            online.advance_decoding(scores)
        text = words(online, True)
        try:
            sock.sendall((text + "\n").encode())
        except ConnectionError:
            pass                        # the client is gone
        log.info("tcp client %s: %s", addr, text)

    def listening(port: int) -> None:
        log.info("online2-tcp: listening on port %d", port)
        print(port, flush=True)     # actual port (0 → the system's)

    serve_connections(handle, "0.0.0.0", po["port-num"],
                      po["max-connections"], on_listen=listening)
    log.info("online2-tcp: fbank kernel launches %d", mfcc.kernel.launches)
    return 0
