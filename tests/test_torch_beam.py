"""PyTorch BeamDecoder against kaldi_tpu's BeamDecoder (CPU tensors).

Mirrors tests/test_beam_lattice.py (exhaustive within-beam oracle,
native vs numpy lattice build, binding arc budget, with_overrides) and
holds the port to the JAX decoder on a small large-vocabulary task
with the device β-prune on and off, escalation included.  Costs agree
within 1e-3 (the same float32 operations in the same order; the host
lattice passes are the port's copies of the original's).  Each side
decodes a graph built by its own package from the same seed and
parameters; the port runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import kaldi_tpu.am as jam
import kaldi_tpu.fst as jfst
import kaldi_tpu_torch.am.topology as ttopo
import kaldi_tpu_torch.am.transitions as ttrans
import kaldi_tpu_torch.am.tree as ttree
import kaldi_tpu_torch.fst as tfst
from kaldi_tpu.decoder import SimpleDecoder
from kaldi_tpu.decoder import beam as jbeam
from kaldi_tpu.fst import arpa as jarpa
from kaldi_tpu.fst import biglang as jbig
from kaldi_tpu.fst import csr as jcsr
from kaldi_tpu.pipelines import largevocab as jlv
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.decoder import beam as tbeam
from kaldi_tpu_torch.fst import arpa as tarpa
from kaldi_tpu_torch.fst import biglang as tbig
from kaldi_tpu_torch.fst import csr as tcsr
from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)

# each package's own graph-building modules: (HmmTopology,
# MonophoneContextDependency, TransitionModel, fst package, arpa, biglang,
# csr)
JAX = (jam.HmmTopology, jam.MonophoneContextDependency, jam.TransitionModel,
       jfst, jarpa, jbig, jcsr)
PORT = (ttopo.HmmTopology, ttree.MonophoneContextDependency,
        ttrans.TransitionModel, tfst, tarpa, tbig, tcsr)


def yesno_graph(side, topology, **mkgraph_kw):
    """(lang, transition model, HCLG) of the yes/no task, built by one
    package (``JAX`` or ``PORT``)."""
    Topo, Tree, TM, fst = side[:4]
    lang = fst.Lang(fst.Lexicon(entries=[("YES", ["Y", "EH", "S"]),
                                         ("NO", ["N", "OW"])]))
    phones = lang.phone_list()
    topo = getattr(Topo, topology)(phones)
    tm = TM(topo, Tree(phones, topo))
    arpa = fst.ArpaModel.parse(fst.make_unigram_arpa({"YES": 1.0,
                                                      "NO": 1.0}))
    return lang, tm, fst.mkgraph(lang, tm, fst.arpa_to_fst(arpa, lang.words),
                                 **mkgraph_kw)


@pytest.fixture(scope="module")
def small_graph():
    """{side: (lang, tm, CsrGraph)} for the chain-topology yes/no task."""
    out = {}
    for name, side in (("jax", JAX), ("port", PORT)):
        lang, tm, HCLG = yesno_graph(side, "chain", self_loop_scale=1.0)
        out[name] = (lang, tm, side[6].pack_fst(HCLG))
    return out


def _all_paths(csr, loglikes, pdf_of, eps_bound=8):
    """Exhaustive (tids, words) → min cost over all graph paths."""
    T = loglikes.shape[0]
    out = {}

    def go(state, t, depth, tids, words, cost):
        if t == T:
            f = csr.final_costs[state]
            if np.isfinite(f):
                key = (tuple(tids), tuple(words))
                if cost + f < out.get(key, np.inf):
                    out[key] = cost + f
        if depth < eps_bound:
            for i in range(csr.n_offsets[state], csr.n_offsets[state + 1]):
                go(int(csr.n_nextstate[i]), t, depth + 1, tids,
                   words + ([int(csr.n_olabel[i])]
                            if csr.n_olabel[i] else []),
                   cost + float(csr.n_weight[i]))
        if t < T:
            for i in range(csr.e_offsets[state], csr.e_offsets[state + 1]):
                il = int(csr.e_ilabel[i])
                go(int(csr.e_nextstate[i]), t + 1, 0, tids + [il],
                   words + ([int(csr.e_olabel[i])]
                            if csr.e_olabel[i] else []),
                   cost + float(csr.e_weight[i]) - loglikes[t][pdf_of[il]])

    go(csr.start, 0, 0, [], [], 0.0)
    return out


def _lattice_paths(lat):
    """(tids, words) → min cost over lattice paths."""
    out = {}

    def go(s, tids, words, cost):
        if s in lat.finals:
            gc, ac = lat.finals[s]
            key = (tuple(tids), tuple(words))
            if cost + gc + ac < out.get(key, np.inf):
                out[key] = cost + gc + ac
        for a in lat.arcs[s]:
            go(a.nextstate, tids + ([a.ilabel] if a.ilabel else []),
               words + ([a.olabel] if a.olabel else []), cost + a.total)

    go(lat.start, [], [], 0.0)
    return out


def _exact_cfg(mod, csr):
    return mod.BeamDecoderConfig(
        beam=1e9, max_active=csr.num_states, acoustic_scale=1.0,
        lattice_beam=6.0, lattice_arcs_per_frame=4 * csr.num_states)


@pytest.mark.parametrize("seed", range(4))
def test_lattice_exact_within_beam(small_graph, seed):
    """Every graph path within lattice_beam of the best is in the port's
    raw lattice at its exact cost, and the within-beam path set equals
    the JAX decoder's."""
    lang, tm, csr = small_graph["port"]
    _, jtm, jcsr_ = small_graph["jax"]
    ll = np.random.default_rng(seed).standard_normal(
        (6, tm.num_pdfs)).astype(np.float32)
    lb = 6.0
    got = _lattice_paths(tbeam.BeamDecoder(
        csr, tm.tid_to_pdf_array, _exact_cfg(tbeam, csr),
        device="cpu").decode_lattice(ll))
    truth = _all_paths(csr, ll, tm.tid_to_pdf_array)
    best = min(truth.values())
    assert abs(min(got.values()) - best) < 1e-3
    for key, c in truth.items():
        if c <= best + lb - 1e-3:
            assert key in got, f"path {key} (cost {c:.3f}) missing"
            assert abs(got[key] - c) < 1e-3
    for key, c in got.items():
        assert key in truth
        assert c >= truth[key] - 1e-3
    want = _lattice_paths(jbeam.BeamDecoder(
        jcsr_, jtm.tid_to_pdf_array,
        _exact_cfg(jbeam, jcsr_)).decode_lattice(ll))
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) < 1e-3


def test_native_lattice_matches_numpy(small_graph, monkeypatch):
    """The native C++ raw-lattice build and the copied numpy pass give
    the same lattice through the port's decoder."""
    from kaldi_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip("no native toolchain")
    lang, tm, csr = small_graph["port"]
    rng = np.random.default_rng(5)
    dec = tbeam.BeamDecoder(csr, tm.tid_to_pdf_array, _exact_cfg(tbeam, csr),
                            device="cpu")
    for _ in range(3):
        ll = rng.standard_normal((10, tm.num_pdfs)).astype(np.float32)
        lat_native = dec.decode_lattice(ll)
        with monkeypatch.context() as m:
            m.setenv("KALDI_TPU_NO_NATIVE", "1")
            lat_numpy = dec.decode_lattice(ll)
        p1, p2 = _lattice_paths(lat_native), _lattice_paths(lat_numpy)
        assert set(p1) == set(p2)
        for k in p1:
            assert abs(p1[k] - p2[k]) < 1e-4
        assert lat_native.num_states == lat_numpy.num_states
        assert lat_native.num_arcs == lat_numpy.num_arcs


def test_host_lattice_backend_names_the_library(monkeypatch):
    from kaldi_tpu_torch import native
    want = "numpy" if native.get_lib() is None else "native C++"
    assert tbeam.host_lattice_backend() == want
    monkeypatch.setenv("KALDI_TPU_NO_NATIVE", "1")
    assert tbeam.host_lattice_backend() == "numpy"


@pytest.mark.parametrize("seed", range(5))
def test_beam_matches_simple_random_loglikes(seed):
    """Mirrors tests/test_decoder.py: an unpruned port decode equals
    SimpleDecoder on a three-state-topology yes/no graph."""
    _, jtm, jHCLG = yesno_graph(JAX, "three_state")
    _, tm, HCLG = yesno_graph(PORT, "three_state")
    ll = np.random.default_rng(seed).standard_normal(
        (40, tm.num_pdfs)).astype(np.float32)
    ref = SimpleDecoder(jHCLG, acoustic_scale=0.1).decode(
        ll, jtm.tid_to_pdf_array)
    tids, ols, cost = tbeam.BeamDecoder(
        tcsr.pack_fst(HCLG), tm.tid_to_pdf_array,
        tbeam.BeamDecoderConfig(beam=1e9, max_active=10 ** 9,
                                acoustic_scale=0.1), device="cpu").decode(ll)
    assert abs(cost - ref[2]) < 1e-3
    assert tids == ref[0]
    assert ols == ref[1]


def _random_lexicon(rng, n_words, n_phones, maxlen=6):
    phones = [f"p{i:02d}" for i in range(n_phones)]
    return [(f"w{i:04d}", [phones[int(k)] for k in
                           rng.integers(0, n_phones,
                                        int(rng.integers(2, maxlen + 1)))])
            for i in range(n_words)]


def test_arc_budget_cutoff_prefers_best_tokens():
    """With a binding arc budget the cost cutoff keeps the true path:
    the port finds SimpleDecoder's best path, drops arcs, and agrees
    with the JAX decoder on the drop count and the cost."""
    rng = np.random.default_rng(3)
    entries = sorted(_random_lexicon(rng, 500, 14))
    ws = [w for w, _ in entries]
    texts = [[ws[int(k)] for k in rng.integers(0, len(ws),
                                               int(rng.integers(1, 8)))]
             for _ in range(300)]

    def build(side):
        Topo, Tree, TM, _, arpa_mod, big_mod, _ = side
        arpa = arpa_mod.estimate_arpa(texts, order=2, prune_count=1,
                                      vocab=ws)
        words, ptab = big_mod.make_symbol_tables(entries)
        pl = [ptab[p] for p in sorted(
            {p for _, pron in entries for p in pron} | {"SIL"})]
        topo = Topo.chain(pl)
        tree = Tree(pl, topo)
        tm = TM(topo, tree)
        return (big_mod.build_big_graph(entries, arpa, tm, words, ptab,
                                        self_loop_scale=1.0),
                topo, tree, tm, ptab)

    jbig_, _, _, jtm, _ = build(JAX)
    big, topo, tree, tm, ptab = build(PORT)
    pron_of = dict(entries)
    pdfs = []
    for w in texts[0][:4]:
        for p in pron_of[w]:
            st = topo.topology_for_phone(ptab[p])[0]
            fwd = tree.compute([ptab[p]], st.forward_pdf_class)
            slf = tree.compute([ptab[p]], st.self_loop_pdf_class)
            pdfs.extend([fwd] + [slf] * (int(rng.integers(2, 5)) - 1))
    T = len(pdfs)
    ll = np.full((T, tree.num_pdfs), -8.0, np.float32)
    ll[np.arange(T), pdfs] = 0.0
    ref = SimpleDecoder(jcsr.csr_to_vector_fst(jbig_.csr),
                        acoustic_scale=1.0).decode(ll, jtm.tid_to_pdf_array)

    kw = dict(beam=20.0, max_active=1500, acoustic_scale=1.0,
              arc_budget=2048, arc_block=4)
    dec = tbeam.BeamDecoder(big.csr, tm.tid_to_pdf_array,
                            tbeam.BeamDecoderConfig(**kw), device="cpu")
    tids, ols, cost = dec.decode(ll)
    host = dec._decode_host(ll[None], [T])[0]
    assert int(host["dropped_arcs"]) > 0, "budget did not bind"
    assert ols == ref[1]
    assert abs(cost - ref[2]) < 1e-2
    jdec = jbeam.BeamDecoder(jbig_.csr, jtm.tid_to_pdf_array,
                             jbeam.BeamDecoderConfig(**kw))
    jt, jo, jc = jdec.decode(ll)
    assert (tids, ols) == (jt, jo) and abs(cost - jc) < 1e-3
    jhost = jdec._fetch(jdec._decode_jit(jdec._graph_arrays(), ll,
                                         np.int32(T)))
    assert int(host["dropped_arcs"]) == int(jhost["dropped_arcs"])


def test_with_overrides_matches_fresh_decoder(small_graph):
    """A with_overrides sibling (shared packed graph, wider budget) is
    indistinguishable from a fresh decoder at that budget."""
    lang, tm, csr = small_graph["port"]
    rng = np.random.default_rng(41)
    kw = dict(beam=16.0, max_active=200, acoustic_scale=1.0,
              lattice_beam=6.0, arc_block=4, lattice_arcs_per_frame=512)
    base = tbeam.BeamDecoder(csr, tm.tid_to_pdf_array,
                             tbeam.BeamDecoderConfig(arc_budget=64, **kw),
                             device="cpu")
    clone = base.with_overrides(arc_budget=4096)
    fresh = tbeam.BeamDecoder(csr, tm.tid_to_pdf_array,
                              tbeam.BeamDecoderConfig(arc_budget=4096, **kw),
                              device="cpu")
    assert clone.M == fresh.M and clone.MB == fresh.MB
    assert clone._g is base._g
    for _ in range(3):
        ll = rng.standard_normal((10, tm.num_pdfs)).astype(np.float32)
        got = dict(clone.decode_compact(ll, bucket=1).paths())
        want = dict(fresh.decode_compact(ll, bucket=1).paths())
        assert set(got) == set(want) and got
        for w in want:
            assert abs(got[w] - want[w]) < 1e-4
        assert clone.decode(ll)[2] <= base.decode(ll)[2] + 1e-4
    with pytest.raises(KaldiError):
        base.with_overrides(arc_block=8)
    with pytest.raises(KaldiError):
        base.with_overrides(token_capacity=64)


# -- a small large-vocabulary task ------------------------------------------

@pytest.fixture(scope="module")
def lv_task():
    kw = dict(vocab_size=300, order=3, seed=7, closure=False,
              corpus_sentences=600)
    task = tlv.make_largevocab_task(**kw)
    jtask = jlv.make_largevocab_task(**kw)
    ev = tlv.sample_eval_set(task, 4, max_words=6, seed=99)
    rng = np.random.default_rng(1234)
    lls = [tlv.synth_loglikes(task, ev[u], rng, noise=0.5)
           for u in sorted(ev)]
    lens = np.array([len(x) for x in lls], np.int64)
    X = np.zeros((len(lls), int(np.ceil(lens.max() / 32) * 32),
                  task.num_pdfs), np.float32)
    for b, x in enumerate(lls):
        X[b, :len(x)] = x
    return task, jtask, X, lens, kw


def test_largevocab_builders_match_jax(lv_task):
    task, jtask, X, lens, kw = lv_task
    a, b = task.graph.csr, jtask.graph.csr
    for f in ("e_offsets", "e_ilabel", "e_olabel", "e_weight",
              "e_nextstate", "n_offsets", "n_weight", "final_costs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert jlv.sample_eval_set(jtask, 4, max_words=6, seed=99) == \
        tlv.sample_eval_set(task, 4, max_words=6, seed=99)
    sent = tlv.sample_eval_set(task, 1, seed=5)["utt0000"]
    np.testing.assert_array_equal(
        tlv.synth_loglikes(task, sent, np.random.default_rng(8)),
        jlv.synth_loglikes(jtask, sent, np.random.default_rng(8)))


@pytest.mark.parametrize("beta,arc_budget", [(True, 512), (False, 512),
                                             (True, 128)])
def test_largevocab_batch_matches_jax(lv_task, beta, arc_budget):
    """decode_compact_batch: same best-path words, costs within 1e-3,
    and the same escalation count and dropped arcs as the JAX decoder
    (arc_budget 128 makes escalation fire)."""
    task, jtask, X, lens, _ = lv_task
    kw = dict(beam=13.0, max_active=7000, acoustic_scale=1.0,
              lattice_beam=7.0, arc_budget=arc_budget, token_capacity=256,
              arc_block=8, escalate_budget=2048, escalate_deficit=4.0,
              lattice_arcs_per_frame=512, record_capacity=16384,
              device_beta_prune=beta)
    args = (task.graph.csr, task.tm.tid_to_pdf_array)
    jargs = (jtask.graph.csr, jtask.tm.tid_to_pdf_array)
    tdec = tbeam.BeamDecoder(*args, tbeam.BeamDecoderConfig(**kw),
                             device="cpu")
    assert tdec._use_beta(*X.shape[:2]) == beta
    ts, js = {}, {}
    got = tdec.decode_compact_batch(X, lens, stats=ts)
    want = jbeam.BeamDecoder(*jargs, jbeam.BeamDecoderConfig(**kw)) \
        .decode_compact_batch(X, lens, stats=js)
    for g, w in zip(got, want):
        gw, gt, gc = g.best_path()
        ww, wt, wc = w.best_path()
        assert gw == ww and gt == wt
        assert abs(gc - wc) < 1e-3
        assert dict(g.paths()).keys() == dict(w.paths()).keys()
    for k in ("n_escalated", "dropped_arcs", "arcs_peak", "heads_peak"):
        assert ts[k] == js[k], k
    assert abs(ts["min_eff_beam"] - js["min_eff_beam"]) < 1e-6
    if arc_budget == 128:
        assert ts["n_escalated"] > 0


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native lattice library, compiled here into a
    directory of this test's own (its loader builds into one shared name
    that parallel test processes race for, and the loser falls back to
    numpy), or None without a compiler."""
    import ctypes
    import os
    import subprocess
    from kaldi_tpu import native as jnative
    so = str(tmp_path_factory.mktemp("jax_native") / "lib.so")
    srcs = [os.path.join(os.path.dirname(jnative.__file__), s)
            for s in jnative._SOURCES]
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", *srcs, "-o", so],
                       check=True, capture_output=True, timeout=180)
    except (OSError, subprocess.SubprocessError):
        return None
    lib = ctypes.CDLL(so)
    jnative._bind(lib)
    return lib


# the two lattice libraries add a lattice's costs in float64 in different
# orders: a path's total may differ in its last bit
COST_RTOL = 1e-12


def _same_paths(got, want):
    """Equal label sequences in the same order, costs within COST_RTOL."""
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=COST_RTOL, abs=0.0)


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("beta", [True, False])
def test_host_methods_in_step_with_original(lv_task, jax_native_lib,
                                            monkeypatch, beta, backend):
    """The copied host methods give the original's outputs on the same
    host dict (taken from the JAX decoder's fetch), with the original's
    lattice passes in its native library and in numpy: label sequences
    exactly, path costs to COST_RTOL."""
    from kaldi_tpu import native as jnative
    if backend == "native":
        if jax_native_lib is None:
            pytest.skip("no C++ compiler for the JAX package's library")
        monkeypatch.delenv("KALDI_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB",
                        jax_native_lib if backend == "native" else None)
    task, jtask, X, lens, _ = lv_task
    kw = dict(beam=13.0, max_active=300, acoustic_scale=1.0,
              lattice_beam=7.0, token_capacity=256, arc_budget=1024,
              lattice_arcs_per_frame=512, device_beta_prune=beta)
    tdec = tbeam.BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                             tbeam.BeamDecoderConfig(**kw), device="cpu")
    jdec = jbeam.BeamDecoder(jtask.graph.csr, jtask.tm.tid_to_pdf_array,
                             jbeam.BeamDecoderConfig(**kw))
    T = int(lens[0])
    ll = X[0]
    host = jdec._fetch(jdec._decode_jit(jdec._graph_arrays(), ll,
                                        np.int32(T)), lattice=True)
    assert int(host["rec_reversed"]) == int(beta)
    for a, b in zip(tdec._decode_records(host, T, ll),
                    jdec._decode_records(host, T, ll)):
        np.testing.assert_array_equal(a, b)
    assert tdec._backtrace(host, T) == jdec._backtrace(host, T)
    _same_paths(tdec.build_compact_lattice(host, T, ll).paths(),
                jdec.build_compact_lattice(host, T, ll).paths())
    _same_paths(sorted(_lattice_paths(tdec._build_lattice(host, T,
                                                          ll)).items()),
                sorted(_lattice_paths(jdec._build_lattice(host, T,
                                                          ll)).items()))
    # the port's own device records decode to the same fields
    thost = tdec._decode_host(ll[None], [T], lattice=True)[0]
    for a, b in zip(tdec._decode_records(thost, T, ll),
                    jdec._decode_records(host, T, ll)):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))
    # sequence-encoded olabels split into the same chains
    OLSEQ_BASE = tcsr.OLSEQ_BASE
    assert OLSEQ_BASE == jcsr.OLSEQ_BASE
    seqs = [[5, 6, 7], [8, 9]]
    tdec._ol_seqs = jdec._ol_seqs = seqs
    arcs = (np.array([0, 1, 1], np.int32), np.array([1, 2, 3], np.int32),
            np.array([3, 4, 5], np.int32),
            np.array([OLSEQ_BASE, 0, OLSEQ_BASE + 1], np.int32),
            np.array([0.5, 1.0, 2.0], np.float32),
            np.array([0.1, 0.2, 0.3], np.float32), 4)
    for a, b in zip(tdec._expand_arc_ols(*arcs), jdec._expand_arc_ols(*arcs)):
        np.testing.assert_array_equal(a, b)


def test_sortable_bits_orders_like_floats():
    x = torch.tensor([3.5, -0.0, 0.0, -2.0, float("inf"), 1e-30, -1e30,
                      7.25])
    bits = tbeam._sortable_bits(x)
    order = torch.sort(bits, stable=True).indices
    np.testing.assert_array_equal(x[order].numpy(),
                                  np.sort(x.numpy(), kind="stable"))
    assert int(bits[1]) == int(bits[2])        # -0.0 sorts as +0.0
    assert bool((bits >= 0).all() and (bits < 2 ** 32).all())
