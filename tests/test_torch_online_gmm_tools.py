"""The port's legacy online GMM tools (online-wav-gmm-decode-faster,
online-gmm-decode-faster, the UDP server online-server-gmm-decode-faster
with online-net-client, the TCP server online-audio-server-decode-faster
with online-audio-client) and online2-wav-gmm-latgen-faster, each run
through the port's registry with ``--device=cpu`` on tiny files and held
against the JAX package's tool of the same name on the same files (the
tools that tests/test_cli_bank30.py and test_cli_extra.py cover in the
original).

The files are written once by a module fixture from seeded numpy draws:
the yes/no task's HCLG and words, four harmonic waveforms, and a GMM
over MFCC + Δ+ΔΔ (39 dims) whose pdfs are drawn around the frames of
those waveforms, so that the decodes find words and no near-tie of the
two packages' float32 log-likelihoods decides them.  Bars: words and
alignments equal.  The servers bind 127.0.0.1 on a free port, serve a
fixed number of utterances or connections and stop; every socket and
join has a timeout.
"""

import io
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.am.gmm import AmDiagGmm
from kaldi_tpu_torch.am.serialize import write_mdl
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter
from kaldi_tpu_torch.fst.openfst_io import write_fst_path
from test_torch_beam import PORT, yesno_graph

torch.set_num_threads(1)

CPU = ("--device=cpu",)
TIMEOUT = 60.0


def read(spec, holder):
    return dict(SequentialTableReader(spec, holder=holder))


@pytest.fixture(scope="module")
def gsys(tmp_path_factory):
    from kaldi_tpu_torch.features import DeltaFeaturesOptions, add_deltas
    from kaldi_tpu_torch.features.compute import Mfcc, MfccOptions
    from kaldi_tpu_torch.features.window import FrameExtractionOptions
    d = tmp_path_factory.mktemp("ogmm")
    lang, tm, HCLG = yesno_graph(PORT, "three_state")
    write_fst_path(f"{d}/HCLG.fst", HCLG)
    lang.words.write(f"{d}/words.txt")
    rng = np.random.default_rng(30)
    waves = {}
    with TableWriter(f"ark:{d}/wav.ark", holder="wav") as w:
        for i, n in enumerate((9000, 10400, 11200, 12000)):
            t = np.arange(n) / 16000.0
            x = 2000 * np.sin(2 * np.pi * (120 + 90 * i) * t * (
                1 + 0.3 * t)) + 300 * rng.standard_normal(n)
            waves[f"u{i}"] = x.astype(np.int16)
            w[f"u{i}"] = (waves[f"u{i}"], 16000)
    mfcc = Mfcc(MfccOptions(frame_opts=FrameExtractionOptions(dither=0.0)),
                device="cpu")
    feats = {k: add_deltas(mfcc.compute(v.astype(np.float32)),
                           DeltaFeaturesOptions()).numpy()
             for k, v in waves.items()}
    allf = np.concatenate(list(feats.values()))
    P, M, D = tm.num_pdfs, 2, allf.shape[1]
    means = allf[rng.integers(0, len(allf), (P, M))] \
        + 0.1 * allf.std(0) * rng.standard_normal((P, M, D))
    am = AmDiagGmm(np.full((P, M), 0.5), means,
                   np.tile(0.5 * allf.var(0), (P, M, 1)), device="cpu")
    write_mdl(f"{d}/final.mdl", tm, am)
    return {"d": str(d), "lang": lang, "tm": tm, "am": am, "waves": waves,
            "feats": feats}


def _offline_words(gsys):
    """utt → words of the dense decoder on each whole utterance's
    features (the library path, offline)."""
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.fst.openfst_io import read_fst_path
    dec = DenseDecoder(read_fst_path(f"{gsys['d']}/HCLG.fst"),
                       gsys["tm"].tid_to_pdf_array,
                       DenseDecoderConfig(beam=16.0, acoustic_scale=0.1),
                       device="cpu")
    words = gsys["lang"].words
    return {k: [words.find(o) for o in
                dec.decode(gsys["am"].loglikes(f))[1]]
            for k, f in gsys["feats"].items()}


def test_online_wav_gmm_decode_faster(gsys):
    d = gsys["d"]
    outs = {}
    for side, main, extra in (("port", ttools.main, CPU),
                              ("jax", jtools.main, ())):
        assert main(["online-wav-gmm-decode-faster", *extra,
                     f"--word-symbol-table={d}/words.txt",
                     f"{d}/final.mdl", f"{d}/HCLG.fst", f"ark:{d}/wav.ark",
                     f"ark,t:{d}/w.{side}", f"ark:{d}/a.{side}"]) == 0
        outs[side] = (read(f"ark,t:{d}/w.{side}", "text"),
                      read(f"ark:{d}/a.{side}", "ivec"))
    (pw, pa), (jw, ja) = outs["port"], outs["jax"]
    assert pw == jw == _offline_words(gsys)
    assert any(pw.values())
    assert sorted(pa) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k])


def test_online_gmm_decode_faster_stdin_sub(gsys, capsys):
    d = gsys["d"]
    raw = f"{d}/mic.raw"
    with open(raw, "wb") as f:
        f.write(gsys["waves"]["u1"].tobytes())
    lines = {}
    for side, main, extra in (("port", ttools.main, CPU),
                              ("jax", jtools.main, ())):
        assert main(["online-gmm-decode-faster", *extra, f"--audio={raw}",
                     f"{d}/final.mdl", f"{d}/HCLG.fst",
                     f"{d}/words.txt"]) == 0
        lines[side] = capsys.readouterr().out.strip().splitlines()
    assert lines["port"] == lines["jax"]
    assert lines["port"][-1].split() == _offline_words(gsys)["u1"]
    assert lines["port"][0].startswith("partial:")


def _free_port(kind=socket.SOCK_STREAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _in_thread(argv):
    holder = {}

    def target():
        try:
            holder["rc"] = ttools.main(argv)
        except BaseException as e:          # the test reads it
            holder["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    return th, holder


def _client_lines(out, key):
    return {ln.split()[0]: ln.split()[1:] for ln in out.splitlines()
            if ln.split() and ln.split()[0].startswith(key)}


def test_udp_server_and_client(gsys, capsys):
    """The port's UDP server answers 4 utterances from the port's client,
    each with the offline words."""
    d = gsys["d"]
    port = _free_port(socket.SOCK_DGRAM)
    th, holder = _in_thread(["online-server-gmm-decode-faster", *CPU,
                             f"--udp-port={port}", "--max-utterances=4",
                             f"{d}/final.mdl", f"{d}/HCLG.fst",
                             f"{d}/words.txt"])
    time.sleep(1.0)
    assert ttools.main(["online-net-client", "127.0.0.1", str(port),
                        f"ark:{d}/wav.ark"]) == 0
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and holder == {"rc": 0}
    got = _client_lines(capsys.readouterr().out, "u")
    assert got == _offline_words(gsys)


def test_tcp_audio_server_and_clients(gsys, capsys):
    """The port's TCP server serves two port clients at once (two
    utterances each) plus a readiness probe of no audio: RESULT: and
    WORD: lines with the offline words, as the JAX server gives."""
    d = gsys["d"]
    offline = _offline_words(gsys)
    for w0, tag in ((0, "a"), (2, "b")):
        with TableWriter(f"ark:{d}/wav_{tag}.ark", holder="wav") as w:
            for i in (w0, w0 + 1):
                w[f"u{i}"] = (gsys["waves"][f"u{i}"], 16000)
    results = {}
    for side, main in (("port", ttools.main), ("jax", jtools.main)):
        port = _free_port()
        argv = ["online-audio-server-decode-faster", f"--port-num={port}",
                "--max-connections=5", f"{d}/final.mdl", f"{d}/HCLG.fst",
                f"{d}/words.txt"]
        if side == "port":
            th, holder = _in_thread(argv[:1] + list(CPU) + argv[1:])
        else:
            holder = {}
            th = threading.Thread(target=main, args=(argv,), daemon=True)
            th.start()
        deadline = time.time() + TIMEOUT
        up = False
        while time.time() < deadline and not up:
            try:
                probe = socket.create_connection(("127.0.0.1", port),
                                                 timeout=1)
                probe.shutdown(socket.SHUT_WR)
                probe.settimeout(TIMEOUT)
                assert probe.recv(64) == b"RESULT:\n"
                probe.close()
                up = True
            except OSError:
                time.sleep(0.2)
        assert up, "server never came up"
        clients = [threading.Thread(target=ttools.main, args=(
            ["online-audio-client", "127.0.0.1", str(port),
             f"ark:{d}/wav_{tag}.ark"],), daemon=True) for tag in "ab"]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=TIMEOUT)
            assert not c.is_alive()
        th.join(timeout=TIMEOUT)
        assert not th.is_alive()
        assert holder.get("rc", 0) == 0 and "error" not in holder
        out = capsys.readouterr().out
        results[side] = sorted(ln for ln in out.splitlines()
                               if ln.startswith("u"))
    assert results["port"] == results["jax"]
    for k, words in offline.items():
        lines = [ln for ln in results["port"] if ln.split()[0] == k]
        assert f"{k} RESULT:{' '.join(words)}" in lines
        assert sorted(ln for ln in lines if " WORD:" in ln) == sorted(
            f"{k} WORD:{w}" for w in words)


def test_tcp_audio_server_survives_a_client_reset(gsys, capsys):
    """A client that resets its connection mid-stream (RST) ends only
    that connection: the next client gets its RESULT: and WORD: lines
    with the offline words, and the tool exits 0."""
    d = gsys["d"]
    port = _free_port()
    th, holder = _in_thread(["online-audio-server-decode-faster", *CPU,
                             f"--port-num={port}", "--max-connections=2",
                             f"{d}/final.mdl", f"{d}/HCLG.fst",
                             f"{d}/words.txt"])
    deadline = time.time() + TIMEOUT
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=1)
            break
        except OSError:
            assert time.time() < deadline, "server never came up"
            time.sleep(0.2)
    sock.sendall(gsys["waves"]["u0"][:4000].tobytes())
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
    sock.close()                            # RST, mid-stream
    with TableWriter(f"ark:{d}/wav_reset.ark", holder="wav") as w:
        w["u1"] = (gsys["waves"]["u1"], 16000)
    assert ttools.main(["online-audio-client", "127.0.0.1", str(port),
                        f"ark:{d}/wav_reset.ark"]) == 0
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and holder == {"rc": 0}
    words = _offline_words(gsys)["u1"]
    lines = capsys.readouterr().out.splitlines()
    assert f"u1 RESULT:{' '.join(words)}" in lines
    assert sum(ln.startswith("u1 WORD:") for ln in lines) == len(words)


def test_tcp_audio_server_failure_ends_the_tool(gsys, monkeypatch):
    """A GMM failure inside a connection ends the serving and the tool
    (the original's handler lost it and the server waited on)."""
    from kaldi_tpu_torch.am.gmm import AmDiagGmm as Am

    def broken(self, feats):
        raise RuntimeError("device fault")

    monkeypatch.setattr(Am, "loglikes", broken)
    d = gsys["d"]
    port = _free_port()
    th, holder = _in_thread(["online-audio-server-decode-faster", *CPU,
                             f"--port-num={port}", "--max-connections=3",
                             f"{d}/final.mdl", f"{d}/HCLG.fst",
                             f"{d}/words.txt"])
    deadline = time.time() + TIMEOUT
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=1)
            break
        except OSError:
            assert time.time() < deadline, "server never came up"
            time.sleep(0.2)
    sock.sendall(gsys["waves"]["u0"].tobytes())
    sock.shutdown(socket.SHUT_WR)
    sock.settimeout(TIMEOUT)
    assert sock.recv(64) == b""             # closed with no RESULT
    sock.close()
    th.join(timeout=TIMEOUT)
    assert not th.is_alive()
    assert isinstance(holder.get("error"), RuntimeError)


def test_online2_wav_gmm_latgen_faster(gsys):
    d = gsys["d"]
    outs = {}
    for side, main, extra in (("port", ttools.main, CPU),
                              ("jax", jtools.main, ())):
        assert main(["online2-wav-gmm-latgen-faster", *extra,
                     f"--word-symbol-table={d}/words.txt",
                     f"{d}/final.mdl", f"{d}/HCLG.fst", f"ark:{d}/wav.ark",
                     f"ark,t:{d}/o2.{side}"]) == 0
        outs[side] = read(f"ark,t:{d}/o2.{side}", "text")
    assert outs["port"] == outs["jax"] == _offline_words(gsys)


def test_partial_callback_errors_propagate(gsys):
    """_gmm_stream passes over only the decoder's KaldiError; an error
    of the partial callback ends the decode (the original dropped it)."""
    from kaldi_tpu_torch.cli.online2 import online_mfcc
    from kaldi_tpu_torch.cli.tools_bank30 import (_gmm_online_setup,
                                                  _gmm_stream)
    d = gsys["d"]
    _tm, am, dec = _gmm_online_setup(f"{d}/final.mdl", f"{d}/HCLG.fst",
                                     16.0, 0.1, "cpu")

    def cb(ols):
        raise RuntimeError("sink fault")

    with pytest.raises(RuntimeError, match="sink fault"):
        _gmm_stream(am, dec, online_mfcc(16000, "cpu"),
                    gsys["waves"]["u0"], 2880, partial_cb=cb)
