# Copied from kaldi_tpu/fst/arpa.py; imports rewritten to kaldi_tpu_torch; write_arpa added.
"""ARPA n-gram language models: parsing, G.fst compilation, const LM.

Parity targets: src/lm/arpa-file-parser.h (ArpaFileParser),
src/lm/arpa-lm-compiler.h (ArpaLmCompiler — ARPA → G acceptor with
backoff ε-arcs labeled #0 on the input side), and
src/lm/const-arpa-lm.h (ConstArpaLm — a flat in-memory n-gram trie for
fast rescoring without FST composition).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, Arc, SymbolTable, VectorFst

log = get_logger(__name__)

LOG10 = math.log(10.0)


class ArpaModel:
    """Parsed ARPA: ngrams[order] = {tuple(words): (logprob_e, backoff_e)}
    with costs in natural log (converted from the file's log10)."""

    def __init__(self):
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []

    @property
    def order(self) -> int:
        return len(self.ngrams)

    @staticmethod
    def parse(text_or_path: str) -> "ArpaModel":
        if "\n" not in text_or_path:
            with open(text_or_path) as f:
                text = f.read()
        else:
            text = text_or_path
        model = ArpaModel()
        section = None
        counts: List[int] = []
        for raw in text.splitlines():
            line = raw.strip()
            if not line:
                continue
            if line == "\\data\\":
                section = "data"
                continue
            if line.startswith("ngram ") and section == "data":
                counts.append(int(line.split("=")[1]))
                continue
            if line.endswith("-grams:") and line.startswith("\\"):
                order = int(line[1:line.index("-")])
                while len(model.ngrams) < order:
                    model.ngrams.append({})
                section = order
                continue
            if line == "\\end\\":
                break
            if isinstance(section, int):
                parts = line.split()
                n = section
                logp = float(parts[0]) * LOG10
                words = tuple(parts[1:1 + n])
                backoff = (float(parts[1 + n]) * LOG10
                           if len(parts) > 1 + n else 0.0)
                model.ngrams[n - 1][words] = (logp, backoff)
        if not model.ngrams:
            raise KaldiError("Empty or invalid ARPA input")
        return model

    def score(self, history: Tuple[str, ...], word: str) -> float:
        """log P(word | history) with backoff (natural log)."""
        hist = tuple(history)[-(self.order - 1):] if self.order > 1 else ()
        while True:
            ng = hist + (word,)
            if len(ng) <= self.order and ng in self.ngrams[len(ng) - 1]:
                return self.ngrams[len(ng) - 1][ng][0]
            if not hist:
                return -99.0 * LOG10  # OOV / unseen unigram
            bo = self.ngrams[len(hist) - 1].get(hist, (0.0, 0.0))[1]
            hist = hist[1:]
            if bo != 0.0:
                return bo + self.score(hist, word)
            # zero backoff: keep shrinking


def arpa_to_fst(model: ArpaModel, words: SymbolTable,
                backoff_symbol: Optional[int] = None,
                bos: str = "<s>", eos: str = "</s>") -> VectorFst:
    """Compile ARPA → G acceptor (ArpaLmCompiler semantics).

    States = n-gram histories.  Word arcs carry -logprob; backoff arcs go
    to the shortened history with ilabel = backoff_symbol (#0, so LG is
    determinizable) and olabel = ε; <s>/<eos> handled as start/final.
    Words absent from the symbol table are skipped with a warning
    (arpa-lm-compiler.cc does the same for OOVs).
    """
    if backoff_symbol is None:
        backoff_symbol = words.get("#0", 0)
    fst = VectorFst()
    state_of: Dict[Tuple[str, ...], int] = {}

    def get_state(hist: Tuple[str, ...]) -> int:
        # truncate to order-1
        hist = hist[-(model.order - 1):] if model.order > 1 else ()
        while hist and (len(hist) > model.order - 1
                        or (hist not in state_of
                            and hist not in model.ngrams[len(hist) - 1])):
            hist = hist[1:]
        if hist not in state_of:
            state_of[hist] = fst.add_state()
        return state_of[hist]

    null_state = get_state(())
    start_state = get_state((bos,)) if (bos,) in model.ngrams[0] else null_state
    fst.set_start(start_state)

    for n in range(1, model.order + 1):
        for ng, (logp, backoff) in model.ngrams[n - 1].items():
            word = ng[-1]
            hist = ng[:-1]
            src = get_state(hist)
            if word == eos:
                cur = fst.final(src)
                fst.set_final(src, min(cur, -logp))
                continue
            if word == bos:
                # <s> has no incoming arc; its backoff handled below
                dst = get_state(ng)
                if backoff != 0.0 or n < model.order:
                    pass
                continue
            if word not in words:
                log.warning("arpa_to_fst: OOV word %r skipped", word)
                continue
            dst = get_state(ng)
            fst.add_arc(src, Arc(words[word], words[word], -logp, dst))

    # backoff arcs: from each history state to its suffix
    for n in range(1, model.order):
        for ng, (logp, backoff) in model.ngrams[n - 1].items():
            if ng not in state_of:
                continue
            src = state_of[ng]
            dst = get_state(ng[1:])
            if src != dst:
                fst.add_arc(src, Arc(backoff_symbol, EPS, -backoff, dst))
    # highest-order states back off for free is implicit: get_state already
    # truncates unseen histories to their longest seen suffix.
    return fst.arcsort("ilabel")


def estimate_arpa(texts: Sequence[Sequence[str]], order: int = 3,
                  prune_count: int = 1,
                  vocab: Optional[Sequence[str]] = None,
                  bos: str = "<s>", eos: str = "</s>") -> ArpaModel:
    """Estimate a backoff n-gram LM from tokenized sentences and return
    it as an ArpaModel (the role of the reference's train_lm.sh /
    kaldi_lm pipeline producing the ARPA that format_lm.sh compiles).

    Witten–Bell interpolation with count-pruning of higher orders:
    n-grams (n ≥ 2) with count < prune_count are dropped, and their
    probability mass reaches the model through the backoff weights,
    which are renormalized exactly:  bow(h) = (1 − Σ_kept p(w|h)) /
    (1 − Σ_kept p(w|h′)).
    """
    counts: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    for sent in texts:
        toks = [bos] + list(sent) + [eos]
        for i in range(1, len(toks)):
            for n in range(1, order + 1):
                if i - n + 1 < 0:
                    continue
                ng = tuple(toks[i - n + 1:i + 1])
                counts[n - 1][ng] = counts[n - 1].get(ng, 0.0) + 1.0
    # <s> needs a unigram entry (prob is conventionally -99) and history
    counts[0].setdefault((bos,), 0.0)
    # closed-vocabulary floor: every vocab word gets a unigram even if
    # unseen (its probability comes from the smoothing floor below)
    if vocab is not None:
        for w in vocab:
            counts[0].setdefault((w,), 0.0)

    # Witten–Bell interpolated probabilities, lowest order first
    probs: List[Dict[Tuple[str, ...], float]] = [dict() for _ in range(order)]
    uni_tot = sum(c for ng, c in counts[0].items() if ng != (bos,))
    V = max(len(counts[0]) - 1, 1)
    for ng, c in counts[0].items():
        # add-one-ish floor keeps every word reachable
        probs[0][ng] = (c + 0.5) / (uni_tot + 0.5 * V) if ng != (bos,) else 1e-30
    for n in range(2, order + 1):
        hist_tot: Dict[Tuple[str, ...], float] = {}
        hist_uniq: Dict[Tuple[str, ...], int] = {}
        for ng, c in counts[n - 1].items():
            h = ng[:-1]
            hist_tot[h] = hist_tot.get(h, 0.0) + c
            hist_uniq[h] = hist_uniq.get(h, 0) + 1
        for ng, c in counts[n - 1].items():
            h = ng[:-1]
            lam = hist_tot[h] / (hist_tot[h] + hist_uniq[h])
            probs[n - 1][ng] = (lam * c / hist_tot[h]
                                + (1 - lam) * probs[n - 2][ng[1:]])

    # prune higher orders by raw count
    kept: List[Dict[Tuple[str, ...], float]] = [probs[0]]
    for n in range(2, order + 1):
        kept.append({ng: p for ng, p in probs[n - 1].items()
                     if counts[n - 1][ng] >= prune_count})
    # histories must themselves be kept n-grams (ARPA well-formedness)
    for n in range(order, 1, -1):
        for ng in list(kept[n - 1]):
            h = ng[:-1]
            if len(h) >= 2 and h not in kept[len(h) - 1] and h[-1] != eos:
                kept[len(h) - 1][h] = probs[len(h) - 1][h]

    # backoff weights: renormalize pruned mass, lowest order first so the
    # denominator can resolve lower-order probabilities recursively
    model = ArpaModel()
    model.ngrams = [dict() for _ in range(order)]
    for n in range(1, order + 1):
        for ng, p in kept[n - 1].items():
            model.ngrams[n - 1][ng] = (math.log(max(p, 1e-30)), 0.0)
    for n in range(1, order):
        by_hist: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
        for ng in kept[n]:
            by_hist.setdefault(ng[:-1], []).append(ng)
        for h, cont in by_hist.items():
            if h not in model.ngrams[n - 1]:
                continue
            num = 1.0 - sum(kept[n][ng] for ng in cont)
            # lower-order (already backoff-complete) probabilities
            den = 1.0 - sum(
                math.exp(model.score(ng[1:-1], ng[-1])) for ng in cont)
            bow = max(num, 1e-10) / max(den, 1e-10)
            lp = model.ngrams[n - 1][h][0]
            model.ngrams[n - 1][h] = (lp, math.log(bow))
    return model


def write_arpa(model: ArpaModel, path: str) -> None:
    """``model`` as an ARPA file at ``path``, log10 values with 9
    significant digits (the port's own: the lattice rescoring tools read
    their LMs from such files)."""
    lines = ["\\data\\"]
    for order, table in enumerate(model.ngrams, start=1):
        lines.append(f"ngram {order}={len(table)}")
    for order, table in enumerate(model.ngrams, start=1):
        lines += ["", f"\\{order}-grams:"]
        for ctx in sorted(table):
            lp, bow = table[ctx]
            row = f"{lp / LOG10:.9g}\t{' '.join(ctx)}"
            if bow != 0.0:
                row += f"\t{bow / LOG10:.9g}"
            lines.append(row)
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def make_unigram_arpa(word_probs: Dict[str, float]) -> str:
    """Tiny helper: unigram ARPA text from a word → prob dict (used by
    recipe tests the way egs/yesno's local/prepare_lm.sh builds its LM)."""
    total = sum(word_probs.values())
    lines = ["\\data\\", f"ngram 1={len(word_probs) + 2}", "", "\\1-grams:"]
    # sentence boundary symbols get a small share
    lines.append(f"{math.log10(0.5):.6f}\t<s>")
    lines.append(f"{math.log10(0.5):.6f}\t</s>")
    for w, p in sorted(word_probs.items()):
        lines.append(f"{math.log10(p / total * 0.5):.6f}\t{w}")
    lines.append("")
    lines.append("\\end\\")
    return "\n".join(lines)
