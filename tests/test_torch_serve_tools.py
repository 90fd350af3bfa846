"""The port's nnet3 serving tools (nnet3-compute, nnet3-compute-batch,
apply-cmvn-online, online2-wav-dump-features, nnet3-latgen-faster-batch,
-looped, nnet3-latgen-incremental, latgen-incremental-mapped,
online2-wav-nnet3-latgen-incremental, the wake-word decoder and the
online2 TCP server), each run through the port's registry with
``--device=cpu`` on tiny files and held against the JAX package's tool
of the same name on the same files, and against the port's library
(the tools that tests/test_cli_bank{3,13,17,20,23,24,28,29,30,31}.py
cover in the original).

The files are written once by a module fixture from seeded numpy draws:
the yes/no task's .mdl, HCLG and words, a raw nnet3 TDNN-F (13 MFCC
inputs, 3 layers of 32 / 8) and three waveforms of 54, 60 and 75 frames
(multiples of the ×3 subsampling, where the original's online scorer
emits every frame too).  Bars: matrices within 1e-4 of the largest
entry (the two packages' float32 sums differ in order), words and best
paths equal, lattice costs within 1e-4 relative.  The TCP server is
driven by 3 clients at once, each final hypothesis equal to the serial
decode, every socket and join with a timeout.
"""

import errno
import io
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am import nnet3_io as tio
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import write_mdl
from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.fst.openfst_io import write_fst_path
from test_torch_beam import PORT, yesno_graph
from test_torch_online_nnet import numpy_state
from torch_registry import TOOL_COUNT

torch.set_num_threads(1)

CPU = ("--device=cpu",)
REL = 1e-4
TIMEOUT = 60.0
OUT = {}
# samples: 54, 60 and 75 frames of 25 ms / 10 ms
LENGTHS = (9000, 9840, 12340)


def run(name, args, port_opts=CPU, jax=True):
    """Run ``name`` on the port (and the JAX package); ``{out}`` in args
    is a per-side path → (port out, jax out)."""
    outs = {}
    sides = [("port", ttools.main, list(port_opts))]
    if jax:
        sides.append(("jax", jtools.main, []))
    for side, main, extra in sides:
        out = f"{OUT['d']}/{name}.{side}"
        assert main([name, *extra, *[a.replace("{out}", out)
                                     for a in args]]) == 0, side
        outs[side] = out
    return outs["port"], outs.get("jax")


def read(spec, holder):
    return dict(SequentialTableReader(spec, holder=holder))


def close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * max(1.0, np.abs(want).max()))


def same_best(got, want):
    """Two CompactLattice tables: equal keys, best words, costs within
    REL relative."""
    assert sorted(got) == sorted(want)
    for k in want:
        gw, _, gc = got[k].best_path()
        ww, _, wc = want[k].best_path()
        assert list(gw) == list(ww), k
        assert gc == pytest.approx(wc, rel=REL, abs=REL)


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    d = tmp_path_factory.mktemp("serve")
    OUT["d"] = str(d)
    lang, tm, HCLG = yesno_graph(PORT, "three_state")
    P = tm.num_pdfs
    write_mdl(f"{d}/final.mdl", tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device="cpu"))
    write_fst_path(f"{d}/HCLG.fst", HCLG)
    lang.words.write(f"{d}/words.txt")
    cfg = TdnnConfig(feat_dim=13, num_pdfs=P, hidden_dim=32,
                     bottleneck_dim=8, num_layers=3)
    rng = np.random.default_rng(19)
    net = TdnnChain(cfg)
    net.load_state_dict(numpy_state(net, rng))
    net.eval()
    tio.write_raw_model(f"{d}/final.raw", net.state_dict(), cfg)
    waves = {}
    with TableWriter(f"ark:{d}/wav.ark", holder="wav") as w:
        for i, n in enumerate(LENGTHS):
            t = np.arange(n) / 16000.0
            x = 2000 * np.sin(2 * np.pi * (150 + 80 * i) * t) \
                + 300 * rng.standard_normal(n)
            waves[f"utt{i}"] = x.astype(np.int16)
            w[f"utt{i}"] = (waves[f"utt{i}"], 16000)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0)),
                device="cpu")
    feats = {k: mfcc.compute(v.astype(np.float32)).numpy()
             for k, v in waves.items()}
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        for k, v in feats.items():
            w[k] = v
    with torch.no_grad():
        lls = {k: net(torch.from_numpy(v)[None])[0].numpy()
               for k, v in feats.items()}
    with TableWriter(f"ark:{d}/ll.ark", holder="mat") as w:
        for k, v in lls.items():
            w[k] = v
    return {"d": str(d), "lang": lang, "tm": tm, "net": net, "cfg": cfg,
            "waves": waves, "feats": feats, "lls": lls}


def fmt(s, *args):
    return [a.replace("{d}", s["d"]) for a in args]


# ---------------------------------------------------------------------------
# nnet3 forward tools

def test_nnet3_compute(sysd):
    p, j = run("nnet3-compute", fmt(sysd, "{d}/final.raw", "ark:{d}/feats.ark",
                                    "ark:{out}"))
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(sysd["lls"])
    for k, v in sysd["lls"].items():
        close(got[k], want[k])
        np.testing.assert_array_equal(got[k], v)        # the library


@pytest.mark.parametrize("opts", [(), ("--bucket=1", "--batch-size=2")])
def test_nnet3_compute_batch(sysd, opts):
    args = ["--frame-subsampling-factor=1", *opts,
            *fmt(sysd, "{d}/final.raw", "ark:{d}/feats.ark"), "ark:{out}"]
    p, j = run("nnet3-compute-batch", args)
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(want) == sorted(sysd["feats"])
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("norm_vars", ["false", "true"])
def test_apply_cmvn_online(sysd, norm_vars):
    from kaldi_tpu_torch.core import io as kio
    d = sysd["d"]
    x = np.concatenate(list(sysd["feats"].values())).astype(np.float64)
    stats = np.zeros((2, 14))
    stats[0, :13], stats[1, :13], stats[0, 13] = (x.sum(0), (x * x).sum(0),
                                                  len(x))
    with kio.open_wxfilename(f"{d}/gstats") as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, stats)
    p, j = run("apply-cmvn-online", ["--cmn-window=20",
                                     f"--norm-vars={norm_vars}",
                                     f"{d}/gstats", f"ark:{d}/feats.ark",
                                     "ark:{out}"])
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])


def test_online2_wav_dump_features(sysd):
    p, j = run("online2-wav-dump-features",
               ["--chunk-length=0.1", *fmt(sysd, "ark:{d}/wav.ark"),
                "ark:{out}"])
    got, want = read(f"ark:{p}", "mat"), read(f"ark:{j}", "mat")
    for k, v in sysd["feats"].items():
        close(got[k], want[k])
        close(got[k], v)        # streamed = the offline MFCC


# ---------------------------------------------------------------------------
# lattice decodes

LAT = ("--beam=15", "--lattice-beam=6")


def test_nnet3_latgen_faster_batch_dense(sysd):
    args = [*LAT, "--batch-size=2",
            *fmt(sysd, "{d}/final.mdl", "{d}/final.raw", "{d}/HCLG.fst",
                 "ark:{d}/feats.ark"), "ark:{out}"]
    p, j = run("nnet3-latgen-faster-batch", args)
    same_best(read(f"ark:{p}", "clat"), read(f"ark:{j}", "clat"))


def test_nnet3_latgen_faster_batch_beam_branch(sysd, monkeypatch):
    """Above the dense limit (lowered here to the tiny graph) the tool
    decodes in padded batches; each lattice equals the library's
    single-utterance beam decode + determinization."""
    from kaldi_tpu_torch.cli import tools_bank20
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu_torch.fst.csr import pack_fst
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    monkeypatch.setattr(tools_bank20, "DENSE_LIMIT", 0)
    d = sysd["d"]
    p, _ = run("nnet3-latgen-faster-batch",
               [*LAT, "--batch-size=2", f"{d}/final.mdl", f"{d}/final.raw",
                f"{d}/HCLG.fst", f"ark:{d}/feats.ark", "ark:{out}"],
               jax=False)
    dec = BeamDecoder(pack_fst(_load_hclg(f"{d}/HCLG.fst")),
                      sysd["tm"].tid_to_pdf_array, BeamDecoderConfig(
                          beam=15.0, lattice_beam=6.0, acoustic_scale=1.0,
                          max_active=7000, lattice_arcs_per_frame=14000),
                      device="cpu")
    want = {k: determinize_lattice_pruned(dec.decode_lattice(ll), 6.0)
            for k, ll in sysd["lls"].items()}
    got = read(f"ark:{p}", "clat")
    same_best(got, want)
    for k in want:
        assert got[k].num_states == want[k].num_states
        assert got[k].num_arcs == want[k].num_arcs


def test_nnet3_latgen_faster_looped(sysd):
    from kaldi_tpu_torch.cli.tools_bank29 import looped_scores
    args = [*LAT, "--chunk-frames=15", "--extra-context=30",
            *fmt(sysd, "{d}/final.mdl", "{d}/final.raw", "{d}/HCLG.fst",
                 "ark:{d}/feats.ark"), "ark:{out}"]
    p, j = run("nnet3-latgen-faster-looped", args)
    same_best(read(f"ark:{p}", "clat"), read(f"ark:{j}", "clat"))
    # the looped scores equal the offline forward on the rows they emit
    with torch.no_grad():
        for k, x in sysd["feats"].items():
            got = looped_scores(sysd["net"], torch.from_numpy(x), 15, 30,
                                3).numpy()
            close(got, sysd["lls"][k][:len(got)])


def test_nnet3_latgen_incremental(sysd):
    d = sysd["d"]
    args = [*LAT, "--chunk-frames=7", f"--word-symbol-table={d}/words.txt",
            f"{d}/final.mdl", f"{d}/final.raw", f"{d}/HCLG.fst",
            f"ark:{d}/feats.ark", "ark:{out}", "ark,t:{out}.txt"]
    p, j = run("nnet3-latgen-incremental", args)
    same_best(read(f"ark:{p}", "clat"), read(f"ark:{j}", "clat"))
    assert read(f"ark,t:{p}.txt", "text") == read(f"ark,t:{j}.txt", "text")


def test_latgen_incremental_mapped(sysd):
    """On the TDNN-F's outputs as a log-likelihood table: equal to the
    JAX tool and, best path for best path, to nnet3-latgen-incremental on
    the features."""
    d = sysd["d"]
    p, j = run("latgen-incremental-mapped",
               ["--acoustic-scale=1.0", "--beam=15", "--lattice-beam=6",
                "--chunk-frames=7", f"{d}/final.mdl", f"{d}/HCLG.fst",
                f"ark:{d}/ll.ark", "ark:{out}"])
    got = read(f"ark:{p}", "clat")
    same_best(got, read(f"ark:{j}", "clat"))
    q, _ = run("nnet3-latgen-incremental",
               [*LAT, "--chunk-frames=7", f"{d}/final.mdl",
                f"{d}/final.raw", f"{d}/HCLG.fst", f"ark:{d}/feats.ark",
                "ark:{out}"], jax=False)
    same_best(got, read(f"ark:{q}", "clat"))


def test_online2_wav_nnet3_latgen_incremental(sysd):
    args = [*LAT, *fmt(sysd, "{d}/final.mdl", "{d}/final.raw",
                       "{d}/HCLG.fst", "ark:{d}/wav.ark"), "ark:{out}"]
    p, j = run("online2-wav-nnet3-latgen-incremental", args)
    got = read(f"ark:{p}", "clat")
    same_best(got, read(f"ark:{j}", "clat"))
    # streamed = offline on the same computer: the incremental decode of
    # the offline MFCC's scores
    q, _ = run("nnet3-latgen-incremental",
               [*LAT, *fmt(sysd, "{d}/final.mdl", "{d}/final.raw",
                           "{d}/HCLG.fst", "ark:{d}/feats.ark"),
                "ark:{out}"], jax=False)
    same_best(got, read(f"ark:{q}", "clat"))


def _serial_words(sysd):
    """utt → words of the port's online2-wav-nnet3-latgen-faster."""
    d = sysd["d"]
    out = f"{d}/serial.txt"
    assert ttools.main(["online2-wav-nnet3-latgen-faster", *CPU,
                        f"--word-symbol-table={d}/words.txt",
                        f"{d}/final.mdl", f"{d}/final.raw",
                        f"{d}/HCLG.fst", f"ark:{d}/wav.ark",
                        f"ark,t:{out}"]) == 0
    return read(f"ark,t:{out}", "text")


def test_wake_word_decoder(sysd):
    """The wake word is a word on utterance 0's serial best path: the
    tool detects it there, at the frame the library's decoder reaches
    it, as the JAX tool does."""
    serial = _serial_words(sysd)
    assert serial["utt0"], "utterance 0 decodes to no word"
    wake = sysd["lang"].words[serial["utt0"][0]]
    args = [*fmt(sysd, "{d}/final.mdl", "{d}/final.raw", "{d}/HCLG.fst"),
            str(wake), *fmt(sysd, "ark:{d}/wav.ark"), "ark,t:{out}"]
    p, j = run("online2-wav-nnet3-wake-word-decoder-faster", args)
    got, want = read(f"ark,t:{p}", "text"), read(f"ark,t:{j}", "text")
    assert got == want
    assert got["utt0"][0] == "1" and int(got["utt0"][1]) > 0


# ---------------------------------------------------------------------------
# the TCP server

def _start_server(argv):
    """The port's server on a thread → (thread, result holder, port)."""
    holder = {}
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    def target():
        try:
            holder["rc"] = ttools.main(["online2-tcp-nnet3-decode-faster",
                                        *CPU, f"--port-num={port}", *argv])
        except BaseException as e:          # the test reads it
            holder["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    return th, holder, port


def _connect(port):
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=5)
        except OSError:
            time.sleep(0.1)
    raise AssertionError("server never came up")


def _client(port, pcm, out, key):
    """Stream ``pcm`` in 0.18 s chunks, read every reply to EOF."""
    sock = _connect(port)
    sock.settimeout(TIMEOUT)
    data = pcm.tobytes()
    step = 2 * 2880
    got = b""
    try:
        for i in range(0, len(data), step):
            sock.sendall(data[i:i + step])
            time.sleep(0.005)
        sock.shutdown(socket.SHUT_WR)
        while True:
            chunk = sock.recv(4096)
            if not chunk:
                break
            got += chunk
    except OSError as e:
        # the server hung up: mid-send, or before the shutdown
        # (ENOTCONN); a timeout is no hang-up
        if not isinstance(e, ConnectionError) and e.errno != errno.ENOTCONN:
            raise
        out[key + ".closed"] = True
    sock.close()
    out[key] = got


def test_tcp_server_concurrent_clients_equal_serial(sysd):
    """3 clients at once: each final hypothesis ('\\n'-terminated) equals
    the serial decode of its waveform (the port's online2 tool and the
    JAX package's), each got partials ('\\r'-terminated) first."""
    d = sysd["d"]
    serial = _serial_words(sysd)
    p, j = run("online2-wav-nnet3-latgen-faster",
               [f"--word-symbol-table={d}/words.txt", f"{d}/final.mdl",
                f"{d}/final.raw", f"{d}/HCLG.fst", f"ark:{d}/wav.ark",
                "ark,t:{out}"], jax=True)
    assert read(f"ark,t:{j}", "text") == serial
    th, holder, port = _start_server(
        ["--max-connections=3", "--read-timeout=20", f"{d}/final.mdl",
         f"{d}/final.raw", f"{d}/HCLG.fst", f"{d}/words.txt"])
    replies = {}
    clients = [threading.Thread(target=_client,
                                args=(port, sysd["waves"][k], replies, k))
               for k in sorted(sysd["waves"])]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=2 * TIMEOUT)
        assert not c.is_alive()
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and holder == {"rc": 0}
    assert sorted(replies) == sorted(sysd["waves"])
    for k, got in replies.items():
        assert got.endswith(b"\n") and got.count(b"\n") == 1, k
        partials = got[:-1].split(b"\r")
        assert len(partials) > 1, k         # at least one partial
        assert partials[-1].decode().split() == serial[k], k


def _reset_mid_stream(port, pcm, out, key):
    """Stream all but the last 0.18 s chunk of ``pcm``, read the partials
    until the server has been quiet for a second (it then waits in its
    read), and reset the connection (SO_LINGER 0: close sends RST)."""
    sock = _connect(port)
    data = pcm.tobytes()
    step = 2 * 2880
    for i in range(0, len(data) - step, step):
        sock.sendall(data[i:i + step])
    got = b""
    sock.settimeout(TIMEOUT)
    got += sock.recv(4096)
    sock.settimeout(1.0)
    try:
        while True:
            got += sock.recv(4096)
    except socket.timeout:
        pass
    out[key] = got
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
    sock.close()


def test_tcp_server_survives_a_client_reset(sysd):
    """A client that resets mid-stream ends only its own connection: the
    client streaming beside it gets its final (the serial decode's
    words) and the tool exits 0 once both connections are done."""
    d = sysd["d"]
    serial = _serial_words(sysd)
    th, holder, port = _start_server(
        ["--max-connections=2", "--read-timeout=20", f"{d}/final.mdl",
         f"{d}/final.raw", f"{d}/HCLG.fst", f"{d}/words.txt"])
    replies = {}
    clients = [
        threading.Thread(target=_reset_mid_stream, args=(
            port, sysd["waves"]["utt2"], replies, "reset")),
        threading.Thread(target=_client, args=(
            port, sysd["waves"]["utt1"], replies, "utt1"))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=2 * TIMEOUT)
        assert not c.is_alive()
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and holder == {"rc": 0}
    assert replies["reset"].endswith(b"\r")        # it was mid-stream
    got = replies["utt1"]
    assert got.endswith(b"\n") and got.count(b"\n") == 1
    assert got[:-1].split(b"\r")[-1].decode().split() == serial["utt1"]


def test_tcp_server_card_failure_ends_the_tool(sysd, monkeypatch):
    """A scorer error that is not the decoder's KaldiError ends the
    connection with no final line and makes the tool raise (exit
    non-zero), where the original answered an empty final and served
    on."""
    from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer

    def broken(self):
        raise RuntimeError("device fault")

    monkeypatch.setattr(OnlineNnetScorer, "read_new", broken)
    d = sysd["d"]
    th, holder, port = _start_server(
        ["--max-connections=2", "--read-timeout=20", f"{d}/final.mdl",
         f"{d}/final.raw", f"{d}/HCLG.fst", f"{d}/words.txt"])
    replies = {}
    _client(port, sysd["waves"]["utt0"], replies, "utt0")
    th.join(timeout=TIMEOUT)
    assert not th.is_alive()
    assert isinstance(holder.get("error"), RuntimeError)
    assert b"\n" not in replies["utt0"]     # no final hypothesis


def test_wake_word_card_failure_ends_the_tool(sysd, monkeypatch):
    from kaldi_tpu_torch.decoder.online_nnet import OnlineNnetScorer

    def broken(self):
        raise RuntimeError("device fault")

    monkeypatch.setattr(OnlineNnetScorer, "read_new", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        ttools.main(["online2-wav-nnet3-wake-word-decoder-faster", *CPU,
                     *fmt(sysd, "{d}/final.mdl", "{d}/final.raw",
                          "{d}/HCLG.fst"), "1",
                     *fmt(sysd, "ark:{d}/wav.ark", "ark,t:{d}/ww.txt")])


def test_wake_word_passes_over_no_path_yet(sysd, monkeypatch):
    """The decoder's KaldiError on a partial (no path yet) is passed
    over, chunk by chunk, as the original did."""
    from kaldi_tpu_torch.decoder.online import SingleUtteranceDecoder
    real = SingleUtteranceDecoder.get_best_path

    def no_partials(self, use_final_probs=False):
        if not use_final_probs:
            raise KaldiError("online traceback: broken chain")
        return real(self, use_final_probs)

    monkeypatch.setattr(SingleUtteranceDecoder, "get_best_path",
                        no_partials)
    serial = _serial_words(sysd)
    wake = sysd["lang"].words[serial["utt0"][0]]
    out = f"{sysd['d']}/ww_final.txt"
    assert ttools.main(["online2-wav-nnet3-wake-word-decoder-faster", *CPU,
                        *fmt(sysd, "{d}/final.mdl", "{d}/final.raw",
                             "{d}/HCLG.fst"), str(wake),
                        *fmt(sysd, "ark:{d}/wav.ark"), f"ark,t:{out}"]) == 0
    got = read(f"ark,t:{out}", "text")
    # found only on the final path, at the utterance's last frame
    assert got["utt0"][0] == "1"


def test_tools_take_device_and_refuse_without_a_card(sysd, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, args in (
            ("nnet3-compute", fmt(sysd, "{d}/final.raw", "ark:{d}/feats.ark",
                                  "ark:{d}/x.ark")),
            ("online2-tcp-nnet3-decode-faster",
             fmt(sysd, "{d}/final.mdl", "{d}/final.raw", "{d}/HCLG.fst",
                 "{d}/words.txt"))):
        assert ttools.main([name, *args]) == 1
        assert "no CUDA card" in capsys.readouterr().err


SERVING_TOOLS = (
    # A. nnet3 serving
    "nnet3-compute", "nnet3-compute-batch", "apply-cmvn-online",
    "online2-wav-dump-features", "nnet3-latgen-faster-batch",
    "nnet3-latgen-faster-looped", "nnet3-latgen-incremental",
    "latgen-incremental-mapped", "online2-wav-nnet3-latgen-incremental",
    "online2-wav-nnet3-wake-word-decoder-faster",
    "online2-tcp-nnet3-decode-faster",
    # B. the legacy online GMM family
    "online-wav-gmm-decode-faster", "online-gmm-decode-faster",
    "online-server-gmm-decode-faster", "online-net-client",
    "online-audio-server-decode-faster", "online-audio-client",
    "online2-wav-gmm-latgen-faster",
    # C. speaker-adapted GMM decodes
    "gmm-make-regtree", "gmm-est-regtree-mllr", "gmm-est-regtree-fmllr",
    "gmm-est-regtree-fmllr-ali", "gmm-decode-faster-regtree-fmllr",
    "gmm-decode-faster-regtree-mllr", "gmm-latgen-faster-regtree-fmllr",
    "gmm-latgen-map", "gmm-rescore-lattice")
# the tools that only move bytes or host data: no --device
HOST_TOOLS = {"online-net-client", "online-audio-client", "gmm-make-regtree"}


class _Stop(Exception):
    pass


def test_registry_holds_the_serving_tools(monkeypatch):
    """The 27 tools are registered, each a tool of the original (174 →
    201 of the original's; 234 since the nnet2 tools, 277 since the
    nnet1 and nnet3 loop tools; the whole count is
    tests/torch_registry.py's), and each that
    computes takes --device with the default cuda (its options read
    where it parses them)."""
    from kaldi_tpu_torch.core.options import ParseOptions
    assert len(set(SERVING_TOOLS)) == 27
    assert set(SERVING_TOOLS) <= set(ttools.TOOLS)
    assert set(SERVING_TOOLS) <= set(jtools.TOOLS)
    assert len(ttools.TOOLS) == TOOL_COUNT
    seen = {}

    def spy(self, argv=None):
        seen["opts"] = dict(self._opts)
        raise _Stop

    monkeypatch.setattr(ParseOptions, "read", spy)
    for name in SERVING_TOOLS:
        with pytest.raises(_Stop):
            ttools.TOOLS[name]([])
        opt = seen.pop("opts").get("device")
        assert (opt is not None) == (name not in HOST_TOOLS), name
        assert opt is None or opt[1] == "cuda"
