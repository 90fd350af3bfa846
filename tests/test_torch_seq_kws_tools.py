"""The 24 tools of the host decoders, grammars, keyword search and
sequence training, each run once through the port's registry
(``kaldi_tpu_torch.cli.tools.main``, ``--device=cpu`` for those that
compute with tensors) on tiny files: each output equals the port's
library call on the same inputs, and the JAX package's tool of the same
name on the same files (the tools that the original's CLI tests cover:
tests/test_cli_bank{4,9,16,17,21,22,23,24,27,28,29,30}.py).

The files are written once by a module fixture from seeded numpy draws:
a 3-word monophone GMM system (the JAX package's model file, both
packages' graph builders give the same graphs), small- and big-LM ARPA
files, features, a raw nnet3 TDNN-F with seeded weights, grammar FSTs
and wave files.  Bars: host outputs (words, alignments, grammar FSTs,
index files, egs, posteriors, hits, ATWV) equal, byte for byte where
the original writes the file; lattices' best paths equal with costs
within 1e-4 relative (the GMM log-likelihoods of the two packages differ
in float32 rounding); sequence objectives and models within 1e-4
relative of the JAX tool's and equal to the library's.
"""

import io

import numpy as np
import pytest
import torch

from kaldi_tpu.cli import tools as jtools
from kaldi_tpu_torch.cli import tools as ttools
from kaldi_tpu_torch.core.table import SequentialTableReader, TableWriter

torch.set_num_threads(1)

NT = 9000
COST_REL = 1e-4
OBJF_REL = 1e-4
CPU = ("--device=cpu",)


OUT = {}


def run(name, args, port_opts=CPU, jax=True):
    """Run ``name`` on the port (and the JAX package); ``{out}`` in args
    is a per-side path in the module's directory → (port out, jax
    out)."""
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


def same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def sysd(tmp_path_factory):
    """Every input file of the tools, written once."""
    from kaldi_tpu.am.gmm import AmDiagGmm
    from kaldi_tpu.am.serialize import write_mdl
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.transitions import TransitionModel
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.fst import (ArpaModel, Lang, Lexicon, arpa_to_fst,
                               make_unigram_arpa, mkgraph)
    from kaldi_tpu.fst.openfst_io import write_fst_path
    from kaldi_tpu_torch.fst.arpa import estimate_arpa, write_arpa
    d = tmp_path_factory.mktemp("seqkws")
    OUT["d"] = str(d)
    rng = np.random.default_rng(17)
    lex = Lexicon([("ONE", ["w", "n"]), ("TWO", ["t", "u"]),
                   ("NINE", ["n", "ai", "n"])])
    lang = Lang(lex)
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tree = MonophoneContextDependency(phones, topo)
    tm = TransitionModel(topo, tree)
    P, D, M = tree.num_pdfs, 4, 2
    am = AmDiagGmm(rng.dirichlet(np.ones(M), size=P),
                   1.5 * rng.standard_normal((P, M, D)),
                   0.5 + rng.random((P, M, D)))
    write_mdl(f"{d}/final.mdl", tm, am)
    lang.words.write(f"{d}/words.txt")
    with open(f"{d}/small.arpa", "w") as f:
        f.write(make_unigram_arpa({"ONE": 1.0, "TWO": 1.0, "NINE": 1.0}))
    # the big LM as an ARPA file (the port's writer: the JAX package
    # has none), read back by both packages
    write_arpa(estimate_arpa([["ONE", "TWO"], ["TWO", "NINE"],
                              ["NINE", "NINE"], ["ONE", "TWO", "NINE"],
                              ["TWO", "NINE", "ONE"]], order=2),
               f"{d}/big.arpa")
    for name, arpa in (("HCLG", "small"), ("HCLG_big", "big")):
        write_fst_path(f"{d}/{name}.fst", mkgraph(lang, tm, arpa_to_fst(
            ArpaModel.parse(f"{d}/{arpa}.arpa"), lang.words)))
    # features: each utterance's frames drawn around the means of a
    # random pdf sequence, so the decodes find words
    means = np.einsum("pm,pmd->pd", np.asarray(am.weights),
                      np.asarray(am.means))
    with TableWriter(f"ark:{d}/feats.ark", holder="mat") as w:
        for i in range(4):
            pdfs = np.repeat(rng.integers(0, P, 6), 4)
            w[f"u{i}"] = (means[pdfs] + 0.3 * rng.standard_normal(
                (len(pdfs), D))).astype(np.float32)
    return {"d": str(d), "tm": tm, "lang": lang, "P": P, "D": D}


def fmt(args, s):
    return [a.replace("{d}", s["d"]) for a in args]


def port_model(s):
    from kaldi_tpu_torch.am.serialize import read_mdl
    return read_mdl(f"{s['d']}/final.mdl", device="cpu")


def feats(s):
    return read(f"ark:{s['d']}/feats.ark", "mat")


def words_of(spec):
    return read(spec, "text")


# ---------------------------------------------------------------------------
# GMM and mapped decoders

def test_gmm_decode_faster_and_simple(sysd):
    from kaldi_tpu_torch.decoder import SimpleDecoder
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    s = sysd
    tm, am = port_model(s)
    HCLG = _load_hclg(f"{s['d']}/HCLG.fst")
    dense = DenseDecoder(HCLG, tm.tid_to_pdf_array,
                         DenseDecoderConfig(beam=16.0, acoustic_scale=0.1),
                         device="cpu")
    simple = SimpleDecoder(HCLG, acoustic_scale=0.1)
    for name, lib in (("gmm-decode-faster", lambda ll: dense.decode(ll)),
                      ("gmm-decode-simple", lambda ll: simple.decode(
                          ll.numpy(), tm.tid_to_pdf_array))):
        p, j = run(name, fmt(["{d}/final.mdl", "{d}/HCLG.fst",
                              "ark:{d}/feats.ark", "ark,t:{out}.w",
                              "ark:{out}.a"], s))
        assert same_bytes(f"{p}.w", f"{j}.w"), name
        assert same_bytes(f"{p}.a", f"{j}.a"), name
        got_w, got_a = words_of(f"ark,t:{p}.w"), read(f"ark:{p}.a", "ivec")
        assert any(got_w.values()), name
        for u, x in feats(s).items():
            tids, ols, _ = lib(am.loglikes(x))
            assert got_w[u] == [str(o) for o in ols], (name, u)
            assert list(got_a[u]) == list(tids), (name, u)


def test_gmm_latgen_simple(sysd):
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    from kaldi_tpu_torch.lattice.determinize import \
        determinize_lattice_pruned
    s = sysd
    p, j = run("gmm-latgen-simple", fmt(
        ["--lattice-beam=6", "{d}/final.mdl", "{d}/HCLG.fst",
         "ark:{d}/feats.ark", "ark:{out}"], s))
    got = read("ark:" + p, "clat")
    want = read("ark:" + j, "clat")
    tm, am = port_model(s)
    dec = DenseDecoder(_load_hclg(f"{s['d']}/HCLG.fst"), tm.tid_to_pdf_array,
                       DenseDecoderConfig(beam=1e9, lattice_beam=6.0,
                                          acoustic_scale=0.1), device="cpu")
    for u, x in feats(s).items():
        lib = determinize_lattice_pruned(
            dec.decode_lattice(am.loglikes(x))[0], 6.0)
        for other in (want[u], lib):
            g, o = got[u].best_path(), other.best_path()
            assert g[0] == o[0] and g[1] == o[1], u
            assert g[2] == pytest.approx(o[2], rel=COST_REL), u
        assert got[u].num_states == lib.num_states


@pytest.mark.parametrize("name", ["gmm-latgen-biglm-faster",
                                  "gmm-decode-biglm-faster"])
def test_gmm_biglm_tools(sysd, name):
    """Each equals the JAX tool and ``BiglmFasterDecoder``; at a beam
    that prunes nothing, the best path is SimpleDecoder's on the big-LM
    graph (the original's property)."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder import SimpleDecoder
    from kaldi_tpu_torch.decoder.biglm import (BiglmDecoderConfig,
                                               BiglmFasterDecoder)
    from kaldi_tpu_torch.fst.arpa import ArpaModel
    s = sysd
    args = ["--beam=1e9", "--max-active=1000000000",
            "--word-symbol-table={d}/words.txt", "{d}/final.mdl",
            "{d}/HCLG.fst", "{d}/small.arpa", "{d}/big.arpa",
            "ark:{d}/feats.ark", "ark,t:{out}"]
    p, j = run(name, fmt(args, s))
    assert same_bytes(p, j)
    got = words_of(f"ark,t:{p}")
    tm, am = port_model(s)
    small, big = (ArpaModel.parse(f"{s['d']}/{n}.arpa")
                  for n in ("small", "big"))
    from kaldi_tpu_torch.fst.fst import SymbolTable
    words = SymbolTable.read(f"{s['d']}/words.txt")
    dec = BiglmFasterDecoder(
        _load_hclg(f"{s['d']}/HCLG.fst"), tm.tid_to_pdf_array, small.score,
        big.score, words, BiglmDecoderConfig(
            beam=1e9, max_active=10 ** 9, acoustic_scale=0.1,
            history_len=1))
    oracle = SimpleDecoder(_load_hclg(f"{s['d']}/HCLG_big.fst"),
                           acoustic_scale=0.1)
    for u, x in feats(s).items():
        ll = am.loglikes(x).numpy()
        _, ols, cost = dec.decode(ll)
        assert got[u] == [words.find(o) for o in ols], u
        _, ols_o, cost_o = oracle.decode(ll, tm.tid_to_pdf_array)
        assert ols == ols_o and cost == pytest.approx(cost_o, abs=1e-3), u


@pytest.mark.parametrize("name", ["decode-faster", "decode-faster-mapped"])
def test_mapped_decoders(sysd, name):
    """Loglike matrices in: decode-faster reads the graph's ilabels − 1 as
    columns, decode-faster-mapped maps tids to pdfs through the model."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.decoder.dense import (DenseDecoder,
                                               DenseDecoderConfig)
    s = sysd
    tm, am = port_model(s)
    HCLG = _load_hclg(f"{s['d']}/HCLG.fst")
    n_il = max(a.ilabel for arcs in HCLG.arcs for a in arcs)
    cols = n_il if name == "decode-faster" else s["P"]
    rng = np.random.default_rng(3)
    spec = f"ark:{s['d']}/ll_{name}.ark"
    lls = {f"u{i}": (2.0 * rng.standard_normal((20, cols))).astype(
        np.float32) for i in range(3)}
    with TableWriter(spec, holder="mat") as w:
        for u, ll in lls.items():
            w[u] = ll
    head = [] if name == "decode-faster" else ["{d}/final.mdl"]
    p, j = run(name, fmt(["--acoustic-scale=1.0"] + head
                         + ["{d}/HCLG.fst", spec, "ark,t:{out}.w",
                            "ark:{out}.a"], s))
    assert same_bytes(f"{p}.w", f"{j}.w") and same_bytes(f"{p}.a", f"{j}.a")
    t2p = (np.concatenate([[0], np.arange(n_il)]).astype(np.int32)
           if name == "decode-faster" else tm.tid_to_pdf_array)
    dec = DenseDecoder(HCLG, t2p, DenseDecoderConfig(beam=16.0,
                                                     acoustic_scale=1.0),
                       device="cpu")
    got = words_of(f"ark,t:{p}.w")
    for u, ll in lls.items():
        assert got[u] == [str(o) for o in dec.decode(ll)[1]], u


# ---------------------------------------------------------------------------
# grammars

@pytest.fixture(scope="module")
def grammar(sysd):
    """The grammar test's graphs (a linear CALL · $CONTACT · NOW graph and
    a contact word loop) over a chain-topology model, its .mdl (a flat
    GMM: the tools read only its transition model), a raw TDNN-F with
    seeded weights (13 inputs), features and waves."""
    from kaldi_tpu.am.gmm import AmDiagGmm
    from kaldi_tpu.am.serialize import write_mdl
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.transitions import TransitionModel
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.fst.fst import Arc, VectorFst
    from kaldi_tpu.fst.openfst_io import write_fst_path
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    d = sysd["d"]
    phones = [1, 2, 3, 4]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    tm = TransitionModel(topo, tree)
    write_mdl(f"{d}/g.mdl", tm, AmDiagGmm.flat_start(
        tree.num_pdfs, np.zeros(13), np.ones(13)))

    def tids(phone):
        st = topo.topology_for_phone(phone)[0]
        fwd = tree.compute([phone], st.forward_pdf_class)
        slf = tree.compute([phone], st.self_loop_pdf_class)
        ts = tm.tuple_to_transition_state(phone, 0, fwd, slf)
        return ([tm.pair_to_transition_id(ts, i)
                 for i, (ns, _) in enumerate(st.transitions) if ns][0],
                tm.self_loop_of(ts))

    def chain(fst, cur, wid, phs, end=None):
        for i, p in enumerate(phs):
            fwd, slf = tids(p)
            nxt = end if (end is not None and i == len(phs) - 1) \
                else fst.add_state()
            fst.add_arc(cur, Arc(fwd, wid if i == 0 else 0, 0.5, nxt))
            fst.add_arc(nxt, Arc(slf, 0, 0.1, nxt))
            cur = nxt
        return cur

    top = VectorFst()
    cur = top.add_state()
    top.set_start(cur)
    cur = chain(top, cur, 10, [1, 2])
    nt_end = top.add_state()
    top.add_arc(cur, Arc(NT, 0, 0.25, nt_end))
    top.set_final(chain(top, nt_end, 11, [2, 1]), 0.0)
    sub = VectorFst()
    loop = sub.add_state()
    sub.set_start(loop)
    sub.set_final(loop, 0.0)
    for wid, phs in ((20, [3, 4]), (21, [4, 3])):
        chain(sub, loop, wid, phs, end=loop)
    write_fst_path(f"{d}/top.fst", top)
    write_fst_path(f"{d}/sub.fst", sub)
    cfg = TdnnConfig(feat_dim=13, num_pdfs=tree.num_pdfs, hidden_dim=16,
                     bottleneck_dim=8, num_layers=2)
    net = TdnnChain(cfg)
    rng = np.random.default_rng(5)
    sd = {k: torch.tensor((1.0 + rng.random(v.shape)) if k.endswith(".var")
                          else 0.4 * rng.standard_normal(v.shape),
                          dtype=torch.float32)
          for k, v in net.state_dict().items()}
    write_raw_model(f"{d}/g.raw", sd, cfg)
    with TableWriter(f"ark:{d}/g_feats.ark", holder="mat") as w:
        for i in range(2):
            w[f"g{i}"] = rng.standard_normal((36, 13)).astype(np.float32)
    with TableWriter(f"ark:{d}/g_wav.ark", holder="wav") as w:
        w["w0"] = ((rng.standard_normal(9600) * 500).astype(np.int16),
                   16000)
    return d


def test_make_grammar_fst(grammar):
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.fst.csr import pack_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    d = grammar
    p, j = run("make-grammar-fst", [f"{d}/top.fst", str(NT),
                                    f"{d}/sub.fst", "{out}"], port_opts=())
    assert same_bytes(p, j)
    lib = replace_nonterminals(pack_fst(_load_hclg(f"{d}/top.fst")),
                               {NT: pack_fst(_load_hclg(f"{d}/sub.fst"))})
    got = pack_fst(_load_hclg(p))
    assert got.num_states == lib.num_states
    assert got.num_emitting_arcs == lib.num_emitting_arcs
    assert got.num_eps_arcs == lib.num_eps_arcs


def test_nnet3_latgen_grammar(grammar):
    """Equal to the JAX tool and to the library decode over
    ``replace_nonterminals``' expanded graph."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.cli.latgen import _LatgenDecoder, _load_hclg
    from kaldi_tpu_torch.cli.online2 import _load_tdnn
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst, pack_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    d = grammar
    p, j = run("nnet3-latgen-grammar", [
        "--frame-subsampling-factor=1", "--acoustic-scale=0.5",
        f"{d}/g.mdl", f"{d}/g.raw", f"{d}/top.fst", str(NT), f"{d}/sub.fst",
        f"ark:{d}/g_feats.ark", "ark:{out}"])
    got = read("ark:" + p, "clat")
    want = read("ark:" + j, "clat")
    tm, _ = read_mdl(f"{d}/g.mdl", device="cpu")
    _, net = _load_tdnn(f"{d}/g.raw", 1, "cpu")
    HCLG = csr_to_vector_fst(replace_nonterminals(
        pack_fst(_load_hclg(f"{d}/top.fst")),
        {NT: pack_fst(_load_hclg(f"{d}/sub.fst"))}))
    dec = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, 15.0, 8.0, 0.5,
                         device="cpu")
    for u, x in read(f"ark:{d}/g_feats.ark", "mat").items():
        with torch.no_grad():
            lib = dec.decode_to_clat(net(torch.tensor(x)[None])[0])
        g = got[u].best_path()
        for other in (want[u], lib):
            o = other.best_path()
            assert g[0] == o[0] and g[1] == o[1], u
            assert g[2] == pytest.approx(o[2], rel=COST_REL), u
        assert g[0][0] == 10 and set(g[0]) <= {10, 11, 20, 21}, g[0]


def test_online2_wav_nnet3_latgen_grammar(grammar, sysd):
    """Equal to the JAX tool, and to the port's streaming tool on the
    library's expanded graph."""
    from kaldi_tpu_torch.cli.latgen import _load_hclg
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst, pack_fst
    from kaldi_tpu_torch.fst.grammar import replace_nonterminals
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    d = grammar
    common = ["--frame-subsampling-factor=1", "--beam=12"]
    p, j = run("online2-wav-nnet3-latgen-grammar", common + [
        f"{d}/g.mdl", f"{d}/g.raw", f"{d}/top.fst", str(NT), f"{d}/sub.fst",
        f"ark:{d}/g_wav.ark", "ark,t:{out}"])
    assert same_bytes(p, j)
    write_fst_path(f"{d}/expanded.fst", csr_to_vector_fst(
        replace_nonterminals(pack_fst(_load_hclg(f"{d}/top.fst")),
                             {NT: pack_fst(_load_hclg(f"{d}/sub.fst"))})))
    lib, _ = run("online2-wav-nnet3-latgen-faster", common + [
        f"{d}/g.mdl", f"{d}/g.raw", f"{d}/expanded.fst",
        f"ark:{d}/g_wav.ark", "ark,t:{out}"], jax=False)
    assert same_bytes(p, lib)
    assert words_of(f"ark,t:{p}")["w0"][0] == "10"


# ---------------------------------------------------------------------------
# keyword search

@pytest.fixture(scope="module")
def kws_lats(sysd):
    """The JAX gmm-latgen-simple's lattices of the 4 utterances, in two
    shards, and a keywords file of the 3 words and one pair."""
    s = sysd
    d = s["d"]
    assert jtools.main(["gmm-latgen-simple", "--lattice-beam=6",
                        f"{d}/final.mdl", f"{d}/HCLG.fst",
                        f"ark:{d}/feats.ark", f"ark:{d}/lats.ark"]) == 0
    lats = read(f"ark:{d}/lats.ark", "clat")
    keys = sorted(lats)
    for name, part in (("a", keys[:2]), ("b", keys[2:])):
        with TableWriter(f"ark:{d}/lats_{name}.ark", holder="clat") as w:
            for k in part:
                w[k] = lats[k]
    ids = [s["lang"].words[w] for w in ("ONE", "TWO", "NINE")]
    with open(f"{d}/kw.txt", "w") as f:
        for i, w in enumerate(ids):
            f.write(f"KW{i} {w}\n")
        f.write(f"KW3 {ids[0]} {ids[1]}\n")
    return d


def test_kws_index_tools(kws_lats):
    """lattice-to-kws-index on two shards and kws-index-union: files
    equal to the JAX tools' and to the library's index; the union
    searches as the direct search does."""
    from kaldi_tpu_torch import kws
    from kaldi_tpu_torch.core import io as kio
    d = kws_lats
    shards = []
    for name in ("a", "b"):
        p, j = run("lattice-to-kws-index", [f"ark:{d}/lats_{name}.ark",
                                            "{out}" + name], port_opts=())
        p, j = p + name, j + name
        assert same_bytes(p, j)
        f = io.BytesIO()
        kio.init_kaldi_output_stream(f)
        kws.write_lattice_index(f, kws.LatticeIndex.build(
            read(f"ark:{d}/lats_{name}.ark", "clat")))
        with open(p, "rb") as g:
            assert g.read() == f.getvalue()
        shards.append(p)
    p, j = run("kws-index-union", ["{out}", *shards], port_opts=())
    assert same_bytes(p, j)
    with kio.open_rxfilename(p) as f:
        kio.init_kaldi_input_stream(f)
        union = kws.read_lattice_index(f)
    lats = read(f"ark:{d}/lats.ark", "clat")
    with open(f"{d}/kw.txt") as f:
        kwl = {p[0]: [int(x) for x in p[1:]] for p in map(str.split, f)}
    direct = kws.keyword_search(lats, kwl, 0.0)
    for kw, seq in kwl.items():
        got = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                     for h in union.search(seq))
        want = sorted((h.utt, h.begin_frame, h.end_frame, h.posterior)
                      for h in direct[kw])
        assert [g[:3] for g in got] == [w[:3] for w in want], kw
        # the index file stores α and β as float32 (the original's
        # write_pytree): posteriors within 1e-5 of the direct search's
        np.testing.assert_allclose([g[3] for g in got],
                                   [w[3] for w in want], rtol=1e-5)


@pytest.mark.parametrize("use_index", ["true", "false"])
def test_kws_search_and_atwv(kws_lats, use_index, capsys):
    from kaldi_tpu_torch import kws
    d = kws_lats
    p, j = run("kws-search", [f"--use-index={use_index}",
                              "--min-posterior=0.05", f"ark:{d}/lats.ark",
                              f"{d}/kw.txt", "ark,t:{out}"], port_opts=())
    assert same_bytes(p, j)
    with open(f"{d}/kw.txt") as f:
        kwl = {q[0]: [int(x) for x in q[1:]] for q in map(str.split, f)}
    lib = kws.keyword_search(read(f"ark:{d}/lats.ark", "clat"), kwl, 0.05)
    got = words_of(f"ark,t:{p}")
    assert sorted(got) == sorted(f"{kw}-{i + 1}" for kw, hs in lib.items()
                                 for i in range(len(hs)))
    for kw, hs in lib.items():
        for i, h in enumerate(hs):
            assert got[f"{kw}-{i + 1}"][:3] == [h.utt, str(h.begin_frame),
                                                str(h.end_frame)]
    # ATWV of the hits against a reference of the top hit of each keyword
    ref = f"ark,t:{d}/ref_{use_index}.txt"
    with TableWriter(ref, holder="text") as w:
        for kw, hs in sorted(lib.items()):
            if hs:
                w[f"{kw}-1"] = [hs[0].utt, str(hs[0].begin_frame),
                                str(hs[0].end_frame)]
    capsys.readouterr()
    outs = []
    for main in (ttools.main, jtools.main):
        assert main(["compute-atwv", "--frame-tolerance=5", "2000", ref,
                     f"ark,t:{p}"]) == 0
        outs.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    assert -1000.0 < float(outs[0]) <= 1.0


# ---------------------------------------------------------------------------
# sequence training

@pytest.fixture(scope="module")
def degs(sysd, kws_lats):
    """Numerator alignments (the best paths of the lattices), a raw
    TDNN-F with seeded weights over the GMM system's pdfs (4 inputs),
    and the egs each package's get-egs writes."""
    from kaldi_tpu_torch.am.nnet3_io import write_raw_model
    from kaldi_tpu_torch.am.tdnn import TdnnChain, TdnnConfig
    s = sysd
    d = s["d"]
    lats = read(f"ark:{d}/lats.ark", "clat")
    with TableWriter(f"ark:{d}/num_ali.ark", holder="ivec") as w:
        for u, lat in lats.items():
            w[u] = s["tm"].tid_to_pdf_array[np.asarray(
                lat.best_path()[1])].astype(np.int32)
    cfg = TdnnConfig(feat_dim=s["D"], num_pdfs=s["P"], hidden_dim=16,
                     bottleneck_dim=8, num_layers=2,
                     frame_subsampling_factor=1)
    net = TdnnChain(cfg)
    rng = np.random.default_rng(11)
    sd = {k: torch.tensor((1.0 + rng.random(v.shape)) if k.endswith(".var")
                          else 0.3 * rng.standard_normal(v.shape),
                          dtype=torch.float32)
          for k, v in net.state_dict().items()}
    write_raw_model(f"{d}/0.raw", sd, cfg)
    p, j = run("nnet3-discriminative-get-egs", [
        f"{d}/final.mdl", f"ark:{d}/feats.ark", f"ark:{d}/num_ali.ark",
        f"ark:{d}/lats.ark", "ark:{out}"], port_opts=())
    return d, p, j


def test_discriminative_get_egs_and_holders(sysd, degs):
    """get-egs equal to the JAX tool's archive and to the library's
    dense lattices; a ``deg`` archive round-trips through both packages'
    holders to the same bytes."""
    from kaldi_tpu.core.table import SequentialTableReader as JReader
    from kaldi_tpu.core.table import TableWriter as JWriter
    from kaldi_tpu_torch.am.discriminative import (lattice_to_dense,
                                                   remove_eps_arcs)
    from kaldi_tpu_torch.lattice.lattice import compact_to_lattice
    d, p, j = degs
    assert same_bytes(p, j)
    egs = read(f"ark:{p}", "deg")
    lats = read(f"ark:{d}/lats.ark", "clat")
    assert sorted(egs) == sorted(lats)
    for u, eg in egs.items():
        dl = lattice_to_dense(remove_eps_arcs(compact_to_lattice(lats[u])),
                              sysd["tm"].tid_to_pdf_array)
        for f in ("src", "dst", "pdf", "w", "mask", "final"):
            np.testing.assert_array_equal(getattr(eg, f), getattr(dl, f), f)
    with JWriter(f"ark:{d}/rt_jax.ark", holder="deg") as w:
        for k, eg in egs.items():
            w[k] = eg
    with TableWriter(f"ark:{d}/rt_port.ark", holder="deg") as w:
        for k, eg in JReader(f"ark:{d}/rt_jax.ark", holder="deg"):
            w[k] = eg
    assert same_bytes(f"{d}/rt_jax.ark", f"{d}/rt_port.ark")
    assert same_bytes(f"{d}/rt_port.ark", p)


@pytest.mark.parametrize("name,opts", [
    ("nnet3-discriminative-copy-egs", ["--n=2"]),
    ("nnet3-discriminative-shuffle-egs", ["--srand=3"]),
    ("nnet3-discriminative-merge-egs", ["--minibatch-size=2"]),
    ("nnet3-discriminative-subset-egs", ["--n=3"])])
def test_discriminative_egs_tools(degs, name, opts):
    d, p_egs, _ = degs
    p, j = run(name, opts + [f"ark:{p_egs}", "ark:{out}"], port_opts=())
    assert same_bytes(p, j)
    src = read(f"ark:{p_egs}", "deg")
    got = read(f"ark:{p}", "deg")
    want_n = {"nnet3-discriminative-copy-egs": 2,
              "nnet3-discriminative-subset-egs": 3}.get(name, len(src))
    assert len(got) == want_n


def _objf(main, raw, egs_spec, criterion, capsys, extra=()):
    capsys.readouterr()
    assert main(["nnet3-discriminative-compute-objf", *extra,
                 f"--criterion={criterion}", raw, egs_spec]) == 0
    return float(capsys.readouterr().out.strip().splitlines()[-1].split()[1])


def _library_objf(raw, egs_spec, criterion):
    from kaldi_tpu_torch.am.discriminative import frame_accuracy
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
    from kaldi_tpu_torch.pipelines.discriminative import sequence_objf
    net, _ = _read_raw_auto(raw, "cpu")
    tot = []
    with torch.no_grad():
        for _, eg in SequentialTableReader(egs_spec, holder="deg"):
            lat = eg.dense_lattice()
            acc = (frame_accuracy(lat, eg.num_ali) if criterion == "smbr"
                   else np.zeros(lat.src.shape, np.float32))
            scores = torch.log_softmax(net(torch.tensor(eg.feats)[None])[0],
                                       dim=-1)
            tot.append(float(sequence_objf(criterion, lat, scores,
                                           torch.tensor(eg.num_ali),
                                           torch.tensor(acc), 0.1)))
    return sum(tot) / len(tot)


@pytest.mark.parametrize("criterion", ["smbr", "mmi"])
def test_discriminative_train_and_objf(degs, criterion, capsys):
    """-train then -compute-objf: the port's model and objective equal the
    library's steps on the same egs, and the JAX tools' within 1e-4;
    the objective rises."""
    from kaldi_tpu_torch.am.discriminative import frame_accuracy, lattice_to
    from kaldi_tpu_torch.am.nnet3_io import read_raw_model
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
    from kaldi_tpu_torch.pipelines.discriminative import (adam,
                                                          sequence_step)
    d, p_egs, _ = degs
    spec = f"ark:{p_egs}"
    before = _objf(ttools.main, f"{d}/0.raw", spec, criterion, capsys, CPU)
    assert before == pytest.approx(_objf(jtools.main, f"{d}/0.raw", spec,
                                         criterion, capsys), rel=OBJF_REL)
    assert before == pytest.approx(_library_objf(f"{d}/0.raw", spec,
                                                  criterion), rel=1e-6)
    opts = [f"--criterion={criterion}", "--num-epochs=3",
            "--learning-rate=0.003"]
    p, j = run("nnet3-discriminative-train",
               opts + [f"{d}/0.raw", spec, "{out}"])
    # the library's steps from the same start
    net, cfg = _read_raw_auto(f"{d}/0.raw", "cpu")
    opt = adam(net, 0.003)
    egs = read(spec, "deg")
    for _ in range(3):
        for _key, eg in egs.items():
            lat = eg.dense_lattice()
            acc = (frame_accuracy(lat, eg.num_ali) if criterion == "smbr"
                   else np.zeros(lat.src.shape, np.float32))
            sequence_step(net, opt, criterion, torch.tensor(eg.feats),
                          torch.tensor(eg.num_ali).long(),
                          torch.tensor(acc), lattice_to(lat, "cpu"), 0.1)
    got = read_raw_model(p, cfg)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    after = _objf(ttools.main, p, spec, criterion, capsys, CPU)
    assert after == pytest.approx(_objf(jtools.main, j, spec, criterion,
                                        capsys), rel=OBJF_REL)
    assert after > before


def test_discriminative_compute_from_egs(degs):
    from kaldi_tpu_torch.cli.tools_bank16 import _read_raw_auto
    d, p_egs, _ = degs
    p, j = run("nnet3-discriminative-compute-from-egs",
               [f"{d}/0.raw", f"ark:{p_egs}", "ark:{out}"])
    got = read("ark:" + p, "mat")
    want = read("ark:" + j, "mat")
    net, _ = _read_raw_auto(f"{d}/0.raw", "cpu")
    for u, eg in read(f"ark:{p_egs}", "deg").items():
        with torch.no_grad():
            lib = net(torch.tensor(eg.feats)[None])[0].numpy()
        np.testing.assert_array_equal(got[u], lib)
        np.testing.assert_allclose(got[u], want[u], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[u]).max())


@pytest.mark.parametrize("name,unit", [("lattice-to-smbr-post", "pdf"),
                                       ("lattice-to-mpe-post", "phone")])
def test_sequence_posteriors(sysd, kws_lats, name, unit):
    from kaldi_tpu_torch.cli.tools_bank17 import _seq_posteriors
    d = kws_lats
    lats = read(f"ark:{d}/lats.ark", "clat")
    with TableWriter(f"ark:{d}/tid_ali.ark", holder="ivec") as w:
        for u, lat in lats.items():
            w[u] = np.asarray(lat.best_path()[1], np.int32)
    p, j = run(name, [f"{d}/final.mdl", f"ark:{d}/tid_ali.ark",
                      f"ark:{d}/lats.ark", "ark:{out}"], port_opts=())
    assert same_bytes(p, j)
    tm, _ = port_model(sysd)
    got = read(f"ark:{p}", "post")
    for u, lat in lats.items():
        lib = _seq_posteriors(lat, tm, list(lat.best_path()[1]), 1.0, unit)
        assert len(got[u]) == len(lib)
        for g, w in zip(got[u], lib):
            assert [i for i, _ in g] == [i for i, _ in w]
            np.testing.assert_allclose([x for _, x in g],
                                       [x for _, x in w], rtol=1e-6,
                                       atol=1e-7)


def test_registry_holds_the_slice():
    """The 24 tools are registered (137 → 161 of the original's; 174
    with the chain training loop's 13, tests/test_torch_chain_loop_tools.py;
    201 with the serving and regression-tree tools; 234 with the nnet2
    tools; 277 with the nnet1 and nnet3 loop tools)."""
    from kaldi_tpu_torch.cli import TOOLS
    slice_tools = {
        "gmm-latgen-biglm-faster", "gmm-decode-biglm-faster",
        "gmm-latgen-simple", "gmm-decode-simple", "gmm-decode-faster",
        "decode-faster", "decode-faster-mapped", "make-grammar-fst",
        "nnet3-latgen-grammar", "online2-wav-nnet3-latgen-grammar",
        "lattice-to-kws-index", "kws-index-union", "kws-search",
        "compute-atwv", "lattice-to-smbr-post", "lattice-to-mpe-post",
        *(f"nnet3-discriminative-{t}" for t in (
            "get-egs", "copy-egs", "shuffle-egs", "train", "compute-objf",
            "merge-egs", "subset-egs", "compute-from-egs"))}
    assert len(slice_tools) == 24 and slice_tools <= set(TOOLS)
    assert len(TOOLS) == 277
