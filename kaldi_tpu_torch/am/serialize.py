"""Model serialization: the repo's binary .mdl files, without JAX.

Copied from kaldi_tpu/am/serialize.py (``read_topology`` /
``write_topology``, ``read_tree`` / ``write_tree``,
``read_transition_model`` / ``write_transition_model``,
``read_am_diag_gmm`` / ``write_am_diag_gmm``, ``read_mdl`` /
``write_mdl``): that module imports ``kaldi_tpu.am.gmm``, and through
it JAX.  The wire format is the original's, so a model written by
either package reads back bit for bit in the other; the GMM part comes
back as the port's ``AmDiagGmm``, bound to ``device`` (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Tuple

import numpy as np

from kaldi_tpu_torch.am.topology import HmmState, HmmTopology
from kaldi_tpu_torch.am.transitions import TransitionModel
from kaldi_tpu_torch.am.tree import (MonophoneContextDependency,
                                     TreeContextDependency, TreeNode)
from kaldi_tpu_torch.core import io as kio
from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.am.gmm import AmDiagGmm


def write_topology(f: BinaryIO, topo: HmmTopology) -> None:
    kio.write_token(f, "<Topology>")
    kio.write_int_vector(f, topo.phones)
    kio.write_basic_int32(f, len(topo.phones))
    for p in topo.phones:
        entry = topo.entries[p]
        kio.write_basic_int32(f, len(entry))
        for st in entry:
            kio.write_basic_int32(f, st.forward_pdf_class)
            kio.write_basic_int32(f, st.self_loop_pdf_class)
            kio.write_basic_int32(f, len(st.transitions))
            for ns, prob in st.transitions:
                kio.write_basic_int32(f, ns)
                kio.write_basic_float(f, prob)
    kio.write_token(f, "</Topology>")


def read_topology(f: BinaryIO) -> HmmTopology:
    kio.expect_token(f, "<Topology>")
    phones = kio.read_int_vector(f).tolist()
    n = kio.read_basic_int32(f)
    entries: Dict[int, List[HmmState]] = {}
    for p in phones[:n]:
        num_states = kio.read_basic_int32(f)
        states = []
        for _ in range(num_states):
            fwd = kio.read_basic_int32(f)
            slf = kio.read_basic_int32(f)
            nt = kio.read_basic_int32(f)
            trans = [(kio.read_basic_int32(f), kio.read_basic_float(f))
                     for _ in range(nt)]
            states.append(HmmState(fwd, slf, trans))
        entries[p] = states
    kio.expect_token(f, "</Topology>")
    return HmmTopology(phones, entries)


def _write_tree_node(f: BinaryIO, node: TreeNode) -> None:
    if node.kind == "leaf":
        kio.write_token(f, "CE")        # ConstantEventMap
        kio.write_basic_int32(f, node.answer)
    else:
        kio.write_token(f, "SE")        # SplitEventMap
        kio.write_basic_int32(f, node.key)
        kio.write_int_vector(f, sorted(node.yes_set))
        _write_tree_node(f, node.yes)
        _write_tree_node(f, node.no)


def _read_tree_node(f: BinaryIO) -> TreeNode:
    tok = kio.read_token(f)
    if tok == "CE":
        return TreeNode("leaf", answer=kio.read_basic_int32(f))
    if tok == "SE":
        key = kio.read_basic_int32(f)
        yes_set = frozenset(kio.read_int_vector(f).tolist())
        yes = _read_tree_node(f)
        no = _read_tree_node(f)
        return TreeNode("split", key=key, yes_set=yes_set, yes=yes, no=no)
    raise KaldiError(f"Bad tree node token {tok}")


def write_tree(f: BinaryIO, tree) -> None:
    kio.write_token(f, "ContextDependency")
    kio.write_basic_int32(f, tree.context_width)
    kio.write_basic_int32(f, tree.central_position)
    if isinstance(tree, MonophoneContextDependency):
        kio.write_token(f, "MONO")
        kio.write_basic_int32(f, tree.num_pdfs)
        pairs = sorted(tree._map.items())
        kio.write_basic_int32(f, len(pairs))
        for (phone, pc), pdf in pairs:
            kio.write_basic_int32(f, phone)
            kio.write_basic_int32(f, pc)
            kio.write_basic_int32(f, pdf)
    else:
        kio.write_token(f, "TREE")
        kio.write_basic_int32(f, tree.num_pdfs)
        _write_tree_node(f, tree.root)
    kio.write_token(f, "EndContextDependency")


def read_tree(f: BinaryIO):
    kio.expect_token(f, "ContextDependency")
    cw = kio.read_basic_int32(f)
    cp = kio.read_basic_int32(f)
    kind = kio.read_token(f)
    if kind == "MONO":
        num_pdfs = kio.read_basic_int32(f)
        n = kio.read_basic_int32(f)
        tree = MonophoneContextDependency.__new__(MonophoneContextDependency)
        tree.context_width = cw
        tree.central_position = cp
        tree._map = {}
        for _ in range(n):
            phone = kio.read_basic_int32(f)
            pc = kio.read_basic_int32(f)
            pdf = kio.read_basic_int32(f)
            tree._map[(phone, pc)] = pdf
        tree.num_pdfs = num_pdfs
        kio.expect_token(f, "EndContextDependency")
        return tree
    if kind == "TREE":
        num_pdfs = kio.read_basic_int32(f)
        root = _read_tree_node(f)
        kio.expect_token(f, "EndContextDependency")
        return TreeContextDependency(cw, cp, root, num_pdfs)
    raise KaldiError(f"Bad tree kind {kind}")


def write_transition_model(f: BinaryIO, tm: TransitionModel) -> None:
    kio.write_token(f, "<TransitionModel>")
    write_topology(f, tm.topo)
    write_tree(f, tm.tree)
    kio.write_token(f, "<LogProbs>")
    kio.write_vector(f, tm.log_probs)
    kio.write_token(f, "</LogProbs>")
    kio.write_token(f, "</TransitionModel>")


def read_transition_model(f: BinaryIO) -> TransitionModel:
    kio.expect_token(f, "<TransitionModel>")
    topo = read_topology(f)
    tree = read_tree(f)
    tm = TransitionModel(topo, tree)
    kio.expect_token(f, "<LogProbs>")
    log_probs = kio.read_vector(f)
    if len(log_probs) != tm.num_transition_ids + 1:
        raise KaldiError(
            f"read_transition_model: <LogProbs> length {len(log_probs)} != "
            f"num-transition-ids+1 = {tm.num_transition_ids + 1} "
            "(truncated or mismatched file)")
    tm.log_probs = log_probs
    kio.expect_token(f, "</LogProbs>")
    kio.expect_token(f, "</TransitionModel>")
    return tm


def write_am_diag_gmm(f: BinaryIO, am: AmDiagGmm) -> None:
    kio.write_token(f, "<DIMENSION>")
    kio.write_basic_int32(f, am.dim)
    kio.write_token(f, "<NUMPDFS>")
    kio.write_basic_int32(f, am.num_pdfs)
    kio.write_token(f, "<MAXMIX>")
    kio.write_basic_int32(f, am.max_mix)
    kio.write_token(f, "<WEIGHTS>")
    kio.write_matrix(f, am.weights, dtype="float64")
    kio.write_token(f, "<MEANS>")
    kio.write_matrix(f, am.means.reshape(am.num_pdfs * am.max_mix, am.dim),
                     dtype="float64")
    kio.write_token(f, "<VARS>")
    kio.write_matrix(f, am.vars.reshape(am.num_pdfs * am.max_mix, am.dim),
                     dtype="float64")


def read_am_diag_gmm(f: BinaryIO, device="cuda") -> AmDiagGmm:
    kio.expect_token(f, "<DIMENSION>")
    dim = kio.read_basic_int32(f)
    kio.expect_token(f, "<NUMPDFS>")
    num_pdfs = kio.read_basic_int32(f)
    kio.expect_token(f, "<MAXMIX>")
    max_mix = kio.read_basic_int32(f)
    kio.expect_token(f, "<WEIGHTS>")
    weights = kio.read_matrix(f).astype(np.float64)
    kio.expect_token(f, "<MEANS>")
    means = kio.read_matrix(f).astype(np.float64).reshape(num_pdfs, max_mix,
                                                          dim)
    kio.expect_token(f, "<VARS>")
    variances = kio.read_matrix(f).astype(np.float64).reshape(num_pdfs,
                                                              max_mix, dim)
    return AmDiagGmm(weights, means, variances, device=device)


def write_mdl(path: str, tm: TransitionModel, am: AmDiagGmm) -> None:
    """final.mdl = TransitionModel then AmDiagGmm (gmm-global convention)."""
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        write_transition_model(f, tm)
        write_am_diag_gmm(f, am)


def read_mdl(path: str, device="cuda") -> Tuple[TransitionModel, AmDiagGmm]:
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError("expected binary .mdl")
        tm = read_transition_model(f)
        am = read_am_diag_gmm(f, device)
        return tm, am


# Copied from kaldi_tpu/am/serialize.py (the den graph's file format).
def write_pytree(f: BinaryIO, tree) -> None:
    """Nested dict of arrays/scalars, keys written sorted."""
    import numpy as _np
    kio.write_token(f, "<Tree>")
    if isinstance(tree, dict) or hasattr(tree, "items"):
        kio.write_token(f, "<Dict>")
        items = sorted(tree.items())
        kio.write_basic_int32(f, len(items))
        for k, v in items:
            kio.write_token(f, f"<{k}>")
            write_pytree(f, v)
    else:
        arr = _np.asarray(tree)
        if arr.dtype.kind in "iu":
            kio.write_token(f, "<IArr>")
            kio.write_basic_int32(f, arr.ndim)
            for d in arr.shape:
                kio.write_basic_int32(f, int(d))
            kio.write_int_vector(f, arr.reshape(-1).astype(_np.int32))
        else:
            kio.write_token(f, "<FArr>")
            kio.write_basic_int32(f, arr.ndim)
            for d in arr.shape:
                kio.write_basic_int32(f, int(d))
            kio.write_vector(f, arr.reshape(-1).astype(_np.float32))
    kio.write_token(f, "</Tree>")


def read_pytree(f: BinaryIO):
    import numpy as _np
    kio.expect_token(f, "<Tree>")
    tok = kio.read_token(f)
    if tok == "<Dict>":
        n = kio.read_basic_int32(f)
        out = {}
        for _ in range(n):
            k = kio.read_token(f)
            out[k[1:-1]] = read_pytree(f)
        val = out
    elif tok in ("<IArr>", "<FArr>"):
        nd = kio.read_basic_int32(f)
        shape = tuple(kio.read_basic_int32(f) for _ in range(nd))
        flat = (kio.read_int_vector(f) if tok == "<IArr>"
                else kio.read_vector(f))
        val = _np.asarray(flat).reshape(shape)
        if nd == 0:
            val = val.reshape(())
    else:
        raise KaldiError(f"read_pytree: unexpected token {tok}")
    kio.expect_token(f, "</Tree>")
    return val
