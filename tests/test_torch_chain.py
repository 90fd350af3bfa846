"""The port's chain objective (kaldi_tpu_torch/am/chain.py and the
kernel wrapper ops/chain_den.py) against the JAX package's am/chain.py.

Each side builds its den graphs with its own package from the same phone
sequences; the arrays must be equal.  Scores, masks and numerator graphs
are drawn from numpy and fed to both.  Tolerances: graphs exactly; log Z
and its gradient rtol/atol 1e-4 (float32 recursions summed in other
orders); the numerators and chain_objf rtol 1e-5 / atol 1e-5.  The
kernel's own recursion (scaled linear space, β pass on the packed arcs)
runs here as ``CudaChainDen`` on the CPU, its plain version; the CUDA
kernels themselves run in the ``gpu`` test and in chip_smoke.py.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_tpu.am import chain as jc
from kaldi_tpu.am import tree as jtree
from kaldi_tpu.am.topology import HmmTopology as JTopo
from kaldi_tpu.core import io as jkio
from kaldi_tpu_torch.am import chain as tc
from kaldi_tpu_torch.am import tree as ttree
from kaldi_tpu_torch.am.topology import HmmTopology as TTopo
from kaldi_tpu_torch.core import io as tkio
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.ops import chain_den

torch.set_num_threads(1)

GRAPH_FIELDS = ("src", "dst", "pdf", "logw", "initial", "final", "l_self",
                "l_fwd", "state_self_pdf", "state_entry_pdf", "lm_initial",
                "lm_l_self", "lm_l_fwd", "lm_final")


def den_pair(kind: str, phones=(1, 2, 3, 4), order=3, seed=9):
    """The same den graph built by each package: "mono" (monophone
    tree) or "biphone" (full left-biphone tree)."""
    rng = np.random.default_rng(seed)
    seqs = [[int(p) for p in rng.choice(phones, 12)] for _ in range(30)]
    out = []
    for topo_cls, tree_mod, chain in ((JTopo, jtree, jc),
                                      (TTopo, ttree, tc)):
        topo = topo_cls.chain(list(phones))
        tree = (tree_mod.MonophoneContextDependency(list(phones), topo)
                if kind == "mono"
                else tree_mod.full_biphone_tree(list(phones), topo))
        out.append(chain.make_denominator_graph(seqs, tree, topo,
                                                order=order))
    return out[0], out[1], tree.num_pdfs


def tiny_pair():
    kw = dict(num_states=2,
              src=np.array([0, 0, 1, 1], np.int32),
              dst=np.array([0, 1, 1, 0], np.int32),
              pdf=np.array([0, 1, 2, 3], np.int32),
              logw=np.log(np.array([0.6, 0.4, 0.7, 0.3], np.float32)),
              initial=np.log(np.array([0.5, 0.5], np.float32)),
              final=np.log(np.array([0.5, 0.5], np.float32)))
    return jc.DenominatorGraph(**kw), tc.DenominatorGraph(**kw), 4


@pytest.mark.parametrize("kind,order", [("mono", 2), ("mono", 3),
                                        ("biphone", 2)])
def test_den_graph_equals_jax(kind, order):
    jden, tden, _ = den_pair(kind, order=order)
    assert tden.num_states == jden.num_states
    for f in GRAPH_FIELDS:
        a, b = getattr(jden, f), getattr(tden, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert tden.exp_index == jden.exp_index
    assert tden.lm.hists == jden.lm.hists
    np.testing.assert_array_equal(tden.lm.next_state, jden.lm.next_state)


def _inputs(P, B=3, T=9, seed=0, holes=True):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((B, T, P)).astype(np.float32)
    mask = np.ones((B, T), bool)
    if holes:
        mask = rng.random((B, T)) > 0.25
        mask[:, 3] = False              # a hole every sequence shares
        mask[1, 0] = False              # frame 0 counts regardless
        mask[2, -1] = False
    return scores, mask


def _jax_den(jden, scores, mask, leak, limit):
    def f(s):
        return jnp.sum(jc.denominator_logprob(
            jden, s, jnp.asarray(mask), leaky_hmm_coefficient=leak,
            dense_state_limit=limit))
    val = np.asarray(jc.denominator_logprob(
        jden, jnp.asarray(scores), jnp.asarray(mask),
        leaky_hmm_coefficient=leak, dense_state_limit=limit))
    return val, np.asarray(jax.grad(f)(jnp.asarray(scores)))


def _port_den(fn, scores, mask):
    s = torch.tensor(scores, requires_grad=True)
    z = fn(s, torch.from_numpy(mask))
    z.sum().backward()
    return z.detach().numpy(), s.grad.numpy()


GRAPHS = {"tiny": tiny_pair, "trigram": lambda: den_pair("mono")}


@pytest.mark.parametrize("graph", ["tiny", "trigram"])
@pytest.mark.parametrize("leak", [0.1, 1e-3])
@pytest.mark.parametrize("limit", [4096, 0], ids=["dense", "arcs"])
def test_denominator_matches_jax(graph, leak, limit):
    """The plain version, both recursions: value and gradient."""
    jden, tden, P = GRAPHS[graph]()
    scores, mask = _inputs(P, holes=graph == "trigram")
    want, gwant = _jax_den(jden, scores, mask, leak, limit)
    got, g = _port_den(lambda s, m: tc.denominator_logprob(
        tden, s, m, leak, dense_state_limit=limit), scores, mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, gwant, rtol=1e-4, atol=1e-4)


def _ragged(P, B=5, T=12, seed=11):
    """Ragged lengths from T // 2 to T and one hole."""
    rng = np.random.default_rng(seed)
    scores = (2.0 * rng.standard_normal((B, T, P))).astype(np.float32)
    mask = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, B)[:, None]
    mask[3, 4] = False
    return scores, mask


@pytest.mark.parametrize("graph", ["tiny", "trigram", "biphone"])
@pytest.mark.parametrize("leak", [0.1, 1e-3, 0.0])
@pytest.mark.parametrize("batch", ["holes", "ragged"])
def test_kernel_recursion_matches_jax(graph, leak, batch):
    """The kernels' algorithm (scaled linear-space forward, β pass with
    the leak's transpose, frame 0 split between self and entry pdfs) on
    the packed arc tables, as CudaChainDen runs it for a CPU tensor: at
    B = 3 with holes, and at B = 5 with ragged lengths."""
    pair = {"tiny": tiny_pair, "trigram": lambda: den_pair("mono"),
            "biphone": lambda: den_pair("biphone", order=2)}[graph]
    jden, tden, P = pair()
    scores, mask = (_inputs(P, seed=3) if batch == "holes"
                    else _ragged(P))
    want, gwant = _jax_den(jden, scores, mask, leak, 4096)
    k = tc.den_kernel(tden, "cpu")
    got, g = _port_den(lambda s, m: k(s, m, leak), scores, mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, gwant, rtol=1e-4, atol=1e-4)


def _gapped(tden, gap: int):
    """``tden``'s graph on the kernel wrapper with pdf ids from ``gap``
    on shifted up by one: pdf ``gap`` is read by no arc or state."""
    self_pdf, entry_pdf = tc.state_pdfs(tden)

    def shift(a):
        a = np.asarray(a)
        return a + (a >= gap)
    return chain_den.CudaChainDen(
        tden.num_states, tden.src, tden.dst, shift(tden.pdf), tden.logw,
        tden.initial, tden.final, shift(self_pdf), shift(entry_pdf),
        device="cpu")


@pytest.mark.parametrize("where", ["inside", "past the graph's pdfs"])
@pytest.mark.parametrize("graph", ["trigram", "biphone"])
def test_kernel_recursion_ignores_pdfs_the_graph_never_reads(graph, where):
    """A pdf no arc or state reads may carry any score (in training
    nothing holds it down): at +200 over every read pdf it would be each
    frame's largest score, and every e_t would underflow to 0 under the
    recursions' per-frame scale.  The wrapper sets it to -inf, so log Z
    and the gradient are the JAX package's on the read pdfs, and the
    unread pdf's gradient is 0."""
    jden, tden, P = (den_pair("mono") if graph == "trigram"
                     else den_pair("biphone", order=2))
    scores, mask = _ragged(P)
    want, gwant = _jax_den(jden, scores, mask, 0.1, 4096)
    gap = P // 2 if where == "inside" else P
    k = _gapped(tden, gap) if where == "inside" else tc.den_kernel(tden,
                                                                    "cpu")
    wide = np.insert(scores, gap, scores.max() + 200.0, axis=2)
    got, g = _port_den(lambda s, m: k(s, m, 0.1), wide, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.delete(g, gap, axis=2), gwant, rtol=1e-4,
                               atol=1e-4)
    assert not g[:, :, gap].any()
    unmasked = chain_den.ChainDenPlainFn.apply(
        torch.from_numpy(wide), torch.from_numpy(mask).to(torch.uint8), k,
        0.1)
    assert not torch.isfinite(unmasked).all()   # what the mask prevents


def test_posteriors_sum_to_one():
    """d log Z / d scores is a posterior: each active frame sums to 1,
    masked frames (t ≥ 1) get 0, every entry lies in [0, 1]."""
    _, tden, P = den_pair("mono")
    scores, mask = _inputs(P, seed=5)
    want = np.where(mask | (np.arange(mask.shape[1]) == 0), 1.0, 0.0)
    for fn in (lambda s, m: tc.denominator_reference(tden, s, m, 0.1),
               lambda s, m: tc.den_kernel(tden, "cpu")(s, m, 0.1)):
        _, g = _port_den(fn, scores, mask)
        np.testing.assert_allclose(g.sum(axis=2), want, atol=1e-4)
        assert g.min() >= -1e-6 and g.max() <= 1 + 1e-6


def test_numerator_logprob_matches_jax():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((3, 7, 6)).astype(np.float32)
    ali = rng.integers(0, 6, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.3
    want = np.asarray(jc.numerator_logprob(jnp.asarray(scores),
                                           jnp.asarray(ali),
                                           jnp.asarray(mask)))
    gwant = np.asarray(jax.grad(lambda s: jnp.sum(jc.numerator_logprob(
        s, jnp.asarray(ali), jnp.asarray(mask))))(jnp.asarray(scores)))
    s = torch.tensor(scores, requires_grad=True)
    got = tc.numerator_logprob(s, torch.from_numpy(ali),
                               torch.from_numpy(mask))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(s.grad.numpy(), gwant)


def _num_graph(rng, B, S_max, P):
    nseg = rng.integers(1, S_max + 1, B).astype(np.int32)
    return (rng.integers(0, P, (B, S_max)).astype(np.int32),
            rng.integers(0, P, (B, S_max)).astype(np.int32), nseg,
            rng.normal(-1, 0.3, (B, S_max)).astype(np.float32),
            rng.normal(-0.7, 0.1, (B, S_max)).astype(np.float32),
            rng.normal(-2, 0.5, B).astype(np.float32),
            rng.normal(-1, 0.5, B).astype(np.float32))


@pytest.mark.parametrize("weighted", [False, True])
def test_flexible_numerator_matches_jax(weighted):
    """Value and gradient, with a holed mask, with and without the
    normalization weights."""
    rng = np.random.default_rng(2)
    B, T, P = 3, 10, 8
    scores = rng.standard_normal((B, T, P)).astype(np.float32)
    mask = rng.random((B, T)) > 0.2
    ng = _num_graph(rng, B, 5, P)
    ng = ng if weighted else ng[:3]

    def f(s):
        return jnp.sum(jc.numerator_flexible_logprob(
            s, *map(jnp.asarray, ng[:3]), jnp.asarray(mask),
            *map(jnp.asarray, ng[3:])))
    want = np.asarray(jc.numerator_flexible_logprob(
        jnp.asarray(scores), *map(jnp.asarray, ng[:3]), jnp.asarray(mask),
        *map(jnp.asarray, ng[3:])))
    gwant = np.asarray(jax.grad(f)(jnp.asarray(scores)))
    s = torch.tensor(scores, requires_grad=True)
    got = tc.numerator_flexible_logprob(
        s, *map(torch.from_numpy, ng[:3]), torch.from_numpy(mask),
        *map(torch.from_numpy, ng[3:]))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), gwant, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("numerator", ["fixed", "flexible"])
def test_chain_objf_matches_jax(numerator):
    """Loss (with l2), objf, num and den, and the loss's gradient."""
    jden, tden, P = den_pair("mono")
    rng = np.random.default_rng(4)
    B, T = 3, 8
    scores, mask = _inputs(P, B, T, seed=4)
    ali = rng.integers(0, P, (B, T)).astype(np.int32)
    ng = _num_graph(rng, B, 4, P) if numerator == "flexible" else None
    opts_kw = dict(l2_regularize=5e-3, leaky_hmm_coefficient=0.1)

    def jloss(s):
        return jc.chain_objf(
            jden, s, jnp.asarray(ali), jnp.asarray(mask),
            jc.ChainTrainingOptions(**opts_kw),
            num_graph=None if ng is None else tuple(map(jnp.asarray, ng)))
    (jl, jd), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    tl, td = tc.chain_objf(
        tden, s, torch.from_numpy(ali), torch.from_numpy(mask),
        tc.ChainTrainingOptions(**opts_kw),
        num_graph=None if ng is None else tuple(map(torch.from_numpy, ng)))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    for k in ("objf", "num", "den"):
        np.testing.assert_allclose(float(td[k].detach()), float(jd[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def test_chain_objf_lattice_supervision_is_not_ported():
    _, tden, P = tiny_pair()
    s = torch.zeros((1, 3, P))
    with pytest.raises(KaldiError, match="not ported"):
        tc.chain_objf(tden, s, None, torch.ones((1, 3), dtype=torch.bool),
                      num_fsa=({}, 1))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_phone_lm_files_cross(tmp_path, writer):
    jden, tden, _ = den_pair("mono")
    path = str(tmp_path / "lm.bin")
    (jc if writer == "jax" else tc).write_phone_lm(
        path, jden.lm if writer == "jax" else tden.lm)
    lm = (tc if writer == "jax" else jc).read_phone_lm(path)
    assert lm.order == jden.lm.order and lm.phones == jden.lm.phones
    assert lm.hists == jden.lm.hists
    np.testing.assert_allclose(lm.next_logp, jden.lm.next_logp, rtol=1e-6)
    np.testing.assert_array_equal(lm.next_state, jden.lm.next_state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_den_graph_files_cross(writer):
    """A den graph written by one package is read by the other, with
    every array and the phone LM intact."""
    jden, tden, _ = den_pair("biphone", order=2)
    f = io.BytesIO()
    if writer == "jax":
        jkio.init_kaldi_output_stream(f)
        jc.write_denominator_graph(f, jden)
    else:
        tkio.init_kaldi_output_stream(f)
        tc.write_denominator_graph(f, tden)
    f.seek(0)
    reader = tc if writer == "jax" else jc
    (tkio if writer == "jax" else jkio).init_kaldi_input_stream(f)
    back = reader.read_denominator_graph(f)
    assert back.num_states == jden.num_states
    for name in ("src", "dst", "pdf", "logw", "initial", "final", "l_self",
                 "l_fwd", "state_self_pdf", "state_entry_pdf"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(jden, name), err_msg=name)
    assert back.lm.hists == jden.lm.hists


def test_packed_csr_rows_hold_each_states_arcs():
    """Arcs sorted by destination (forward) and by source (backward),
    each (key, other | pdf << 16, exp(logw)), every key's run in the
    graph's own order, then zero-weight padding on the last key."""
    jden, tden, P = den_pair("mono")
    k = tc.den_kernel(tden, "cpu")
    n = k.num_arcs
    for keyt, packed, w, key, other in (
            (k.in_key, k.in_op, k.in_w, tden.dst, tden.src),
            (k.out_key, k.out_op, k.out_w, tden.src, tden.dst)):
        rows, oth, pdf = chain_den._unpack(keyt, packed)
        order = np.argsort(key, kind="stable")
        np.testing.assert_array_equal(rows[:n].numpy(), key[order])
        np.testing.assert_array_equal(oth[:n].numpy(), other[order])
        np.testing.assert_array_equal(pdf[:n].numpy(), tden.pdf[order])
        np.testing.assert_allclose(w[:n].numpy(), np.exp(tden.logw[order]),
                                   rtol=1e-6)
        assert (rows[n:] == int(key[order][-1])).all()
        assert (w[n:] == 0).all()
    assert k.max_pdf == P - 1 and k.launches == 0


@pytest.mark.parametrize("graph", ["tiny", "trigram", "biphone"])
def test_packed_arcs_hold_each_arc_once(graph):
    """Each table holds every arc of the graph exactly once, with its
    (src, dst, pdf, w); its keys never decrease (the kernels' segments);
    its length is a multiple of the kernels' stride and the padding
    carries weight 0."""
    pair = {"tiny": tiny_pair, "trigram": lambda: den_pair("mono"),
            "biphone": lambda: den_pair("biphone", order=2)}[graph]
    _, tden, _ = pair()
    k = tc.den_kernel(tden, "cpu")
    n = k.num_arcs
    want = sorted(zip(tden.src.tolist(), tden.dst.tolist(),
                      tden.pdf.tolist(),
                      np.exp(tden.logw.astype(np.float64))
                      .astype(np.float32).tolist()))
    for keyt, packed, w, forward in ((k.in_key, k.in_op, k.in_w, True),
                                     (k.out_key, k.out_op, k.out_w, False)):
        assert keyt.numel() == packed.numel() == w.numel()
        assert w.numel() % chain_den.ARC_STRIDE == 0
        assert w.numel() - n < chain_den.ARC_STRIDE
        key, oth, pdf = (x.numpy() for x in chain_den._unpack(keyt, packed))
        assert (np.diff(key) >= 0).all()
        src, dst = (oth, key) if forward else (key, oth)
        got = sorted(zip(src[:n].tolist(), dst[:n].tolist(),
                         pdf[:n].tolist(), w[:n].tolist()))
        assert got == want
        assert (w[n:].numpy() == 0).all()


def key_sums(words: np.ndarray, v: np.ndarray, num_keys: int):
    """The kernels' sums by key (csrc/chain_den.cu ``sum_by_key``) in
    numpy over per-arc values v: 4 arcs a thread summed serially, each
    thread's last run carried across the warp by the Hillis-Steele steps
    in the key words' bits, and every flushed piece added up by key."""
    w = words.view(np.uint32)
    k = (w & 0xFFFF).reshape(-1, 4)
    bits = w[0::4]
    vv = v.astype(np.float64).reshape(-1, 4)
    out = np.zeros(num_keys)
    x, first = vv[:, 0].copy(), np.zeros(len(k))
    split = np.zeros(len(k), bool)
    for i in range(1, 4):
        brk = k[:, i] != k[:, i - 1]
        np.add.at(out, k[brk & split, i - 1], x[brk & split])
        first = np.where(brk & ~split, x, first)
        x = np.where(brk, vv[:, i], x + vv[:, i])
        split |= brk
    x = x.reshape(-1, 32)
    b = bits.reshape(-1, 32)
    for i in range(5):
        o = 1 << i
        up = np.concatenate([x[:, :o], x[:, :-o]], axis=1)
        x = np.where((b >> np.uint32(chain_den.KEY_SCAN + i)) & 1, x + up, x)
    below = np.concatenate([x[:, :1], x[:, :-1]], axis=1).reshape(-1)
    x = x.reshape(-1)
    carry = (bits & chain_den.KEY_CARRY) != 0
    np.add.at(out, k[split, 0], first[split] + np.where(carry, below,
                                                        0.0)[split])
    tail = (bits & chain_den.KEY_TAIL) != 0
    np.add.at(out, k[tail, 3], x[tail])
    return out


@pytest.mark.parametrize("graph", ["tiny", "trigram", "biphone"])
@pytest.mark.parametrize("table", ["in", "out"])
def test_scan_bits_sum_each_key_once(graph, table):
    """The kernels' sums by key, run from the packed key words, equal
    the direct sums of each key's arcs."""
    pair = {"tiny": tiny_pair, "trigram": lambda: den_pair("mono"),
            "biphone": lambda: den_pair("biphone", order=2)}[graph]
    _, tden, _ = pair()
    k = tc.den_kernel(tden, "cpu")
    words = getattr(k, f"{table}_key").numpy()
    key = words.view(np.uint32) & 0xFFFF
    v = np.random.default_rng(3).random(len(words))
    np.testing.assert_allclose(key_sums(words, v, k.num_states),
                               np.bincount(key, v, minlength=k.num_states),
                               rtol=1e-12)


@pytest.mark.parametrize("max_run", [3, 40, 300])
def test_scan_bits_on_short_and_long_runs(max_run):
    """Keys in runs of 1 to max_run arcs (several keys in one thread,
    runs across threads and across warps): the sums by key still hold."""
    rng = np.random.default_rng(max_run)
    runs = rng.integers(1, max_run + 1, 400)
    key = np.repeat(np.arange(len(runs)), runs)
    other = rng.integers(0, len(runs), len(key))
    words, _, w = chain_den.pack_arcs(key, other, other % 7,
                                      rng.random(len(key)))
    v = rng.random(len(words))
    k16 = words.view(np.uint32) & 0xFFFF
    np.testing.assert_allclose(key_sums(words, v, len(runs)),
                               np.bincount(k16, v, minlength=len(runs)),
                               rtol=1e-12)
    assert (w[len(key):] == 0).all() and len(words) % 2048 == 0


def _smem(backward, S, P, pref):
    """A stand-in for the library's count of a block's shared memory,
    of its shape: two state rows, one pdf row and 18 words forward (two
    pdf rows and 16 words backward), and a pdf row more with the
    prefetch."""
    per = 2 * S + 2 * P + 16 if backward else 2 * S + P + 18
    return 4 * (per + (P if pref else 0))


H100_SMEM = 232448


@pytest.mark.parametrize("S,P,plan", [
    (1553, 82, (True, True)),        # the bench graph
    (1681, 3444, (True, True)),      # its left-biphone graph
    (28500, 82, (True, True)),
    (28940, 82, (True, False)),      # the backward's prefetch goes first
    (28965, 82, (True, False)),      # the forward's fits to the byte
])
def test_den_plan_prefetches_where_it_fits(S, P, plan):
    got = chain_den.den_plan(S, P, H100_SMEM, _smem)
    assert got == chain_den.DenPlan(*plan)
    assert _smem(0, S, P, got.fwd_pref) <= H100_SMEM
    assert _smem(1, S, P, got.bwd_pref) <= H100_SMEM


def test_den_plan_raises_where_nothing_fits():
    with pytest.raises(KaldiError, match="shared memory"):
        chain_den.den_plan(29100, 82, H100_SMEM, _smem)


def test_layout_constants_match_the_kernel_source():
    """The packer's constants are the kernels' (csrc/chain_den.cu)."""
    import pathlib
    import re
    src = (pathlib.Path(chain_den.__file__).parent.parent / "csrc"
           / "chain_den.cu").read_text()
    defs = dict(re.findall(r"^#define (\w+) (.+)$", src, re.M))
    threads = int(defs["DEN_THREADS"])
    assert defs["DEN_STRIDE"] == "(DEN_THREADS * 4)"
    assert chain_den.ARC_STRIDE == 4 * threads
    assert int(defs["KEY_MASK"].rstrip("u"), 16) == chain_den.MAX_ID
    assert int(defs["KEY_SCAN"]) == chain_den.KEY_SCAN
    for name in ("KEY_CARRY", "KEY_TAIL"):
        bit = int(re.fullmatch(r"\(1u << (\d+)\)", defs[name]).group(1))
        assert 1 << bit == getattr(chain_den, name), name
    assert "S > 65535" in src and "P > 65535" in src


def test_kernel_wrapper_limits():
    """Graphs past the kernel's 16-bit packing raise KaldiError; scores
    narrower than the graph's pdfs, or not float32, are refused."""
    S = chain_den.MAX_ID + 1
    idx = np.arange(S, dtype=np.int32)
    with pytest.raises(KaldiError, match="16 bits"):
        chain_den.CudaChainDen(S, idx, idx, idx % 4,
                               np.zeros(S, np.float32),
                               np.zeros(S, np.float32),
                               np.zeros(S, np.float32), idx % 4, idx % 4,
                               device="cpu")
    _, tden, P = tiny_pair()
    k = tc.den_kernel(tden, "cpu")
    with pytest.raises(ValueError):
        k(torch.zeros((1, 2, P - 1)))
    with pytest.raises(TypeError):
        k(torch.zeros((1, 2, P), dtype=torch.float64))
    with pytest.raises(ValueError, match="mask"):
        k(torch.zeros((1, 2, P)), torch.ones((1, 3), dtype=torch.bool))


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tden, P = den_pair("mono")
    scores, mask = _inputs(P, B=8, T=20, seed=7)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for leak in (0.1, 1e-3):
        want, gwant = _port_den(
            lambda s, m: tc.denominator_reference(tden, s.to(dev),
                                                  m.to(dev), leak).cpu(),
            scores, mask)
        got, g = _port_den(
            lambda s, m: tc.denominator_logprob(tden, s.to(dev), m.to(dev),
                                                leak).cpu(), scores, mask)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g, gwant, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("pref", [True, False])
def test_kernel_matches_plain_with_and_without_prefetch(pref):
    """The kernels with and without the score prefetch against the plain
    version, on ragged lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tden, P = den_pair("mono")
    scores, mask = _ragged(P, T=20, seed=8)
    dev = torch.device("cuda")
    k = tc.den_kernel(tden, dev)
    want, gwant = _port_den(
        lambda s, m: tc.denominator_reference(tden, s.to(dev), m.to(dev),
                                              0.1).cpu(), scores, mask)
    got, g = _port_den(
        lambda s, m: chain_den.ChainDenFn.apply(
            s.to(dev).contiguous(), m.to(dev).to(torch.uint8), k, 0.1,
            chain_den.DenPlan(pref, pref)).cpu(), scores, mask)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, gwant, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernel_carries_a_nan_score():
    """A NaN score makes its sequence's log Z and the gradient rows of
    its active frames NaN, as in the plain version on the CPU; the other
    sequences are untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tden, P = den_pair("mono")
    scores, mask = _ragged(P, T=20, seed=8)
    scores[1, 6, 0] = np.nan
    got, g = _port_den(lambda s, m: tc.den_kernel(tden, "cuda")(
        s.cuda(), m.cuda(), 0.1).cpu(), scores, mask)
    want, gwant = _port_den(lambda s, m: tc.den_kernel(tden, "cpu")(
        s, m, 0.1), scores, mask)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(g).any(axis=2),
                                  np.isnan(gwant).any(axis=2))
    assert np.isnan(g[1, 1:]).any(axis=1).sum() == mask[1, 1:].sum()
    ok = [0, 2, 3, 4]
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g[ok], gwant[ok], rtol=1e-4, atol=1e-4)
