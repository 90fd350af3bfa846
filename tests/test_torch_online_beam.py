"""PyTorch OnlineBeamDecoder / MultiStreamBeamDecoder against kaldi_tpu's
(CPU tensors).

Mirrors tests/test_online_beam.py's five tests and the two streaming
tests of tests/test_escalation.py.  Each side builds the 800-word task
with its own package from the same seed; the same log-likelihoods go
through the port's streaming decoders and the JAX package's
``OnlineBeamDecoder`` in the same cuts.  Finalized lattices must agree:
same best words and tids, costs within 1e-3, path sets within 1e-3;
partial results too.  Multistream lanes are held to the JAX single
stream on the same utterance (the same chunk step per lane), so the JAX
side compiles one chunk program per decoder.  Also: the two reference
faults repaired in the port (the slot < 0 guard and the buffers' memory
guard) and the identity step of idle lanes.
"""

import numpy as np
import pytest
import torch

from kaldi_tpu.decoder import beam as jbeam
from kaldi_tpu.decoder import online_beam as jonline
from kaldi_tpu.pipelines import largevocab as jlv
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.decoder import beam as tbeam
from kaldi_tpu_torch.decoder import online_beam as tonline
from kaldi_tpu_torch.decoder.online import OnlineEndpointRule
from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)

TASK = dict(vocab_size=800, corpus_sentences=800, seed=3)
CFG = dict(beam=14.0, max_active=512, acoustic_scale=1.0, lattice_beam=6.0,
           lattice_arcs_per_frame=1024, record_capacity=16384)
# tests/test_escalation.py's budgets: TIGHT = K (one block per token)
ESC = dict(CFG, arc_block=4)
TIGHT, WIDE = 512, 4096


@pytest.fixture(scope="module")
def tasks():
    return tlv.make_largevocab_task(**TASK), jlv.make_largevocab_task(**TASK)


@pytest.fixture(scope="module")
def decs(tasks):
    task, jtask = tasks
    return (tbeam.BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                              tbeam.BeamDecoderConfig(**CFG), device="cpu"),
            jbeam.BeamDecoder(jtask.graph.csr, jtask.tm.tid_to_pdf_array,
                              jbeam.BeamDecoderConfig(**CFG)))


@pytest.fixture(scope="module")
def jstream(decs):
    """The JAX streaming decoder (one compiled chunk step for the file)."""
    return jonline.OnlineBeamDecoder(decs[1], chunk_frames=16,
                                     max_frames=512)


@pytest.fixture(scope="module")
def esc_decs(tasks):
    """(port tight, port wide, JAX tight streaming decoder)."""
    task, jtask = tasks
    t2p = task.tm.tid_to_pdf_array
    tight = tbeam.BeamDecoder(task.graph.csr, t2p, tbeam.BeamDecoderConfig(
        arc_budget=TIGHT, escalate_budget=WIDE, escalate_deficit=0.0, **ESC),
        device="cpu")
    wide = tbeam.BeamDecoder(task.graph.csr, t2p, tbeam.BeamDecoderConfig(
        arc_budget=WIDE, **ESC), device="cpu")
    jtight = jbeam.BeamDecoder(jtask.graph.csr, jtask.tm.tid_to_pdf_array,
                               jbeam.BeamDecoderConfig(
                                   arc_budget=TIGHT, escalate_budget=WIDE,
                                   escalate_deficit=0.0, **ESC))
    return tight, wide, jonline.OnlineBeamDecoder(jtight, chunk_frames=16,
                                                  max_frames=512)


def _utt(task, rng, n_words=4, noise=0.3):
    words = list(tlv.sample_eval_set(task, 1, max_words=n_words,
                                     seed=int(rng.integers(1 << 30))
                                     ).values())[0]
    return words, tlv.synth_loglikes(task, words, rng, noise=noise)


def _stream(ob, ll, cuts):
    ob.reset()
    for a, b in zip(cuts, cuts[1:]):
        if a < ll.shape[0]:
            ob.advance(ll[a:min(b, ll.shape[0])])
    return ob.finalize()


def _same_lattice(got, want):
    gw, gt, gc = got.best_path()
    ww, wt, wc = want.best_path()
    assert gw == ww and gt == wt and abs(gc - wc) < 1e-3
    g, w = dict(got.paths()), dict(want.paths())
    assert g and set(g) == set(w)
    for k in w:
        assert abs(g[k] - w[k]) < 1e-3


def test_streamed_matches_jax_and_offline(tasks, decs, jstream):
    """Ragged cuts with a mid-stream partial (flush and resume): the
    port's finalized lattice and partial equal the JAX stream's, and
    the lattice equals the port's offline decode."""
    task, _ = tasks
    dec, _ = decs
    rng = np.random.default_rng(5)
    ob = tonline.OnlineBeamDecoder(dec, chunk_frames=16, max_frames=512)
    for _ in range(3):
        _, ll = _utt(task, rng)
        cuts = [0, 7, 23, 40, ll.shape[0]]
        ob.reset()
        jstream.reset()
        for a, b in zip(cuts, cuts[1:]):
            if a < ll.shape[0]:
                ob.advance(ll[a:min(b, ll.shape[0])])
                jstream.advance(ll[a:min(b, ll.shape[0])])
            if a == 23:
                (go, gc), (wo, wc) = ob.partial(), jstream.partial()
                assert go == wo and abs(gc - wc) < 1e-3
        got = ob.finalize()
        _same_lattice(got, jstream.finalize())
        _same_lattice(got, dec.decode_compact(ll, bucket=1))
        assert ob.last_finalize_breakdown["n_records"] > 0


def test_partial_converges_to_final(tasks, decs, jstream):
    task, _ = tasks
    dec, _ = decs
    rng = np.random.default_rng(9)
    words, ll = _utt(task, rng)
    ob = tonline.OnlineBeamDecoder(dec, chunk_frames=16, max_frames=512)
    T = ll.shape[0]
    for o in (ob, jstream):
        o.reset()
        o.advance(ll[:T // 2])
    (mid_ols, mid_cost), (jo, jc) = ob.partial(), jstream.partial()
    assert np.isfinite(mid_cost)
    assert mid_ols == jo and abs(mid_cost - jc) < 1e-3
    for o in (ob, jstream):
        o.advance(ll[T // 2:])
    end_ols, end_cost = ob.partial()
    assert (end_ols, pytest.approx(end_cost, abs=1e-3)) == jstream.partial()
    clat = ob.finalize()
    bw = clat.best_path()[0]
    assert end_ols == bw                 # partial at end == best path
    assert [task.words.find(w) for w in bw] == list(words)
    # a second utterance after reset is independent
    words2, ll2 = _utt(task, rng)
    ob.reset()
    ob.advance(ll2)
    hyp2 = [task.words.find(w) for w in ob.finalize().best_path()[0]]
    assert hyp2 == list(words2)


def test_partial_tids_match_jax_and_offline(tasks, decs, jstream):
    task, _ = tasks
    dec, _ = decs
    rng = np.random.default_rng(21)
    _, ll = _utt(task, rng)
    ob = tonline.OnlineBeamDecoder(dec, chunk_frames=16, max_frames=512)
    ob.advance(ll)
    jstream.reset()
    jstream.advance(ll)
    tids = ob.partial_tids()
    assert len(tids) == ll.shape[0]      # one tid per decoded frame
    assert tids == jstream.partial_tids() == dec.decode(ll)[0]


def test_endpoint_and_best_path_surface(tasks, decs, jstream):
    """get_best_path equals the JAX stream's and the offline decode;
    endpointing answers as the JAX stream does."""
    task, _ = tasks
    dec, _ = decs
    rng = np.random.default_rng(33)
    _, ll = _utt(task, rng)
    ob = tonline.OnlineBeamDecoder(dec, chunk_frames=16, max_frames=512)
    ob.advance(ll)
    jstream.reset()
    jstream.advance(ll)
    tids, ols, cost = ob.get_best_path()
    jt, jo, jc = jstream.get_best_path()
    rt, ro, rc = dec.decode(ll)
    assert tids == jt == rt and ols == jo == ro
    assert abs(cost - jc) < 1e-3 and abs(cost - rc) < 1e-3
    assert ob.num_frames_decoded == jstream.num_frames_decoded == len(ll)
    # rule5 fires on utterance length at frame_shift 1.0; no rule fires
    # with unmeetable requirements
    from kaldi_tpu.decoder.online import OnlineEndpointRule as JRule
    assert ob.endpoint_detected(frame_shift=1.0)
    assert jstream.endpoint_detected(frame_shift=1.0)
    assert not ob.endpoint_detected(
        rules=[OnlineEndpointRule(True, 1e9, 1e10, 1e9)])
    assert not jstream.endpoint_detected(rules=[JRule(True, 1e9, 1e10, 1e9)])
    # trailing silence from the partial tids, taking the last frame's
    # phone as silence
    sil = {task.tm.transition_id_to_phone(tids[-1])}
    n_sil = ob.trailing_silence_frames(task.tm, sil)
    assert n_sil >= 1
    assert n_sil == jstream.trailing_silence_frames(tasks[1].tm, sil)


def _round_robin(ms, lls, n_lanes, chunk):
    """Stream utterances through ``n_lanes`` lanes, a new one into each
    lane that frees; → {utt: finalized lattice}."""
    queue = list(range(len(lls)))
    active, done = {}, {}
    while queue or active:
        for c in range(n_lanes):
            if c not in active and queue:
                active[c] = (queue.pop(0), 0)
        chunks = [None] * n_lanes
        for c, (u, pos) in active.items():
            chunks[c] = lls[u][pos:pos + chunk]
        ms.advance(chunks)
        for c in list(active):
            u, pos = active[c]
            pos += len(chunks[c])
            if pos >= lls[u].shape[0]:
                done[u] = ms.finalize_channel(c)
                ms.reset_channel(c)
                del active[c]
            else:
                active[c] = (u, pos)
    return done


def test_multistream_channels_match_jax_and_offline(tasks, decs, jstream):
    """6 staggered utterances of different lengths over 4 lanes: each
    finalized lattice equals the JAX stream's on the same utterance and
    the port's offline decode; a reset lane decodes the next one."""
    task, _ = tasks
    dec, _ = decs
    rng = np.random.default_rng(41)
    lls = [_utt(task, rng)[1] for _ in range(6)]
    ms = tonline.MultiStreamBeamDecoder(dec, n_channels=4, chunk_frames=16,
                                        max_frames=256)
    done = _round_robin(ms, lls, 4, 16)
    assert len(done) == 6
    for u, ll in enumerate(lls):
        _same_lattice(done[u], _stream(jstream, ll,
                                       list(range(0, len(ll), 16))
                                       + [len(ll)]))
        _same_lattice(done[u], dec.decode_compact(ll, bucket=1))


def _binding_utt(task, tight, seed=7):
    """An utterance on which the tight budget fires the deficit trigger
    (skip-guarded so the test cannot pass vacuously)."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        _, ll = _utt(task, rng, n_words=6, noise=0.9)
        host = tight._decode_host(ll[None], [ll.shape[0]], lattice=True)[0]
        if tight.needs_escalation(host):
            return ll
    pytest.fail("no utterance fired the deficit trigger; tighten TIGHT")


def test_online_finalize_escalates(tasks, esc_decs):
    """finalize honours the escalation policy: a stream whose deficit
    fired re-decodes offline at the escalated budget, so the final
    lattice equals the wide decoder's and the JAX stream's."""
    tight, wide, jtight = esc_decs
    ll = _binding_utt(tasks[0], tight)
    ob = tonline.OnlineBeamDecoder(tight, chunk_frames=16, max_frames=512)
    cuts = list(range(0, ll.shape[0], 13)) + [ll.shape[0]]
    for a, b in zip(cuts, cuts[1:]):          # ragged chunks
        ob.advance(ll[a:b])
    assert float(ob._deficit) > 0.0
    got = ob.finalize()
    assert "escalated_redecode_ms" in ob.last_finalize_breakdown
    _same_lattice(got, wide.decode_compact(ll, bucket=16))
    _same_lattice(got, _stream(jtight, ll, cuts))


def test_multistream_finalize_escalates(tasks, esc_decs):
    """Per-channel deficit and escalation at finalize_channel; an easy
    lane is unaffected, and reset clears the deficit."""
    tight, wide, jtight = esc_decs
    hard = _binding_utt(tasks[0], tight)
    _, easy = _utt(tasks[0], np.random.default_rng(55), n_words=3, noise=0.1)
    ms = tonline.MultiStreamBeamDecoder(tight, n_channels=2, chunk_frames=16,
                                        max_frames=256)
    pos, lls, done = [0, 0], [hard, easy], [None, None]
    while any(d is None for d in done):
        chunks = [None, None]
        for c in range(2):
            if done[c] is None:
                chunks[c] = lls[c][pos[c]:pos[c] + 16]
                pos[c] += len(chunks[c])
        ms.advance(chunks)
        for c in range(2):
            if done[c] is None and pos[c] >= lls[c].shape[0]:
                done[c] = ms.finalize_channel(c)
                ms.reset_channel(c)
    assert float(ms._deficit[0]) == 0.0      # reset cleared it
    _same_lattice(done[0], wide.decode_compact(hard, bucket=16))
    _same_lattice(done[0], _stream(jtight, hard,
                                   list(range(0, len(hard), 16))
                                   + [len(hard)]))
    assert done[1].best_path()[0] == \
        wide.decode_compact(easy, bucket=16).best_path()[0]


def test_idle_lane_takes_the_identity_step(tasks, decs):
    """A lane with no frames in a step keeps its tokens, buffers and
    deficit bit for bit; a lane with fewer frames than the others writes
    only its own rows."""
    task, _ = tasks
    dec, _ = decs
    rng = np.random.default_rng(61)
    a, b = _utt(task, rng)[1], _utt(task, rng)[1]
    maxT = 64

    def lane(ms, c, rows=maxT):
        """Lane c's tokens, deficit and buffer rows [0, rows)."""
        st = ms._st
        return ([x[c].clone() for x in st.tok] + [st.deficit[c].clone()]
                + [x[c, :rows].clone()
                   for x in (st.chunks, st.alphas, st.bpp, st.bpa)])

    def same(x, y):
        assert all(torch.equal(u, v) for u, v in zip(x, y))

    ms = tonline.MultiStreamBeamDecoder(dec, n_channels=3, chunk_frames=8,
                                        max_frames=maxT)
    ms.advance([a[:8], b[:8], None])
    idle, held = lane(ms, 2), lane(ms, 1)
    ms.advance([a[8:16], None, None])        # lanes 1 and 2 idle
    same(lane(ms, 2), idle)
    ms.advance([a[16:19], None, b[:5]])      # ragged: 3, idle, 5 frames
    same(lane(ms, 1), held)
    assert list(ms._st.frames) == [19, 8, 5]
    assert ms._st.fd.tolist() == [19, 8, 5]
    # lane 2's 5 frames equal a lone lane's on the same scores
    one = tonline.MultiStreamBeamDecoder(dec, n_channels=1, chunk_frames=8,
                                         max_frames=maxT)
    one.advance([b[:5]])
    same(lane(ms, 2, 5), lane(one, 0, 5))


def test_path_olabels_guards_a_broken_chain(decs):
    """A traceback that ends before frame 0 raises, as the offline
    backtrace does (the original maps slot −1 to the last initial
    token's olabel)."""
    dec, _ = decs
    with pytest.raises(KaldiError, match="broken backpointer"):
        tonline._path_olabels(dec, np.array([3, 5], np.int32), -1)
    assert tonline._path_olabels(dec, np.array([-1, -1], np.int32), 0) == \
        list(dec._expand_ol(int(dec._init_ols[0])))


def test_stream_buffers_guard_memory(decs):
    """Buffers that would take more than a quarter of the device's
    memory raise before anything is allocated."""
    dec, _ = decs
    need = 10 ** 6 * 512 * (dec.L * (dec._recw + 1) + 3 * dec.K) * 4
    assert need > dec._memory_bytes() // 4
    with pytest.raises(KaldiError, match="quarter"):
        tonline.MultiStreamBeamDecoder(dec, n_channels=10 ** 6,
                                       max_frames=512)
    with pytest.raises(KaldiError, match="quarter"):
        tonline.OnlineBeamDecoder(dec, max_frames=10 ** 9)


def test_max_frames_is_enforced(tasks, decs):
    dec, _ = decs
    _, ll = _utt(tasks[0], np.random.default_rng(3))
    ob = tonline.OnlineBeamDecoder(dec, chunk_frames=8, max_frames=16)
    ob.advance(ll[:16])
    with pytest.raises(KaldiError, match="max_frames"):
        ob.advance(ll[16:24])
