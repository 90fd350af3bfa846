# Copied from kaldi_tpu/fst/lang.py; imports rewritten to kaldi_tpu_torch.
"""Lexicon and language directory preparation.

Parity targets: egs/wsj/s5/utils/prepare_lang.sh,
utils/add_lex_disambig.pl, utils/make_lexicon_fst.pl — producing the
phone/word symbol tables, the lexicon transducer L (phones → words)
with optional silence, and L_disambig with the #1..#N disambiguation
symbols that make L∘G determinizable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from kaldi_tpu_torch.core.logging import KaldiError, get_logger
from kaldi_tpu_torch.fst.fst import EPS, Arc, SymbolTable, VectorFst

log = get_logger(__name__)


@dataclasses.dataclass
class Lexicon:
    """word → list of pronunciations (each a list of phone strings).

    Entries are (word, pron) or (word, pron, prob): the optional
    pronunciation PROBABILITY is the lexiconp.txt column
    (prepare_lang.sh --pron-probs); L carries −log(prob) on the
    word's first arc."""
    entries: List[Tuple]

    def words(self) -> List[str]:
        return sorted({e[0] for e in self.entries})

    def phones(self) -> List[str]:
        return sorted({p for e in self.entries for p in e[1]})

    def normalized(self) -> List[Tuple[str, List[str], float]]:
        """Entries as uniform (word, pron, prob) triples."""
        return [(e[0], list(e[1]),
                 float(e[2]) if len(e) > 2 else 1.0)
                for e in self.entries]


class Lang:
    """The 'lang' directory equivalent: symbol tables + L + L_disambig."""

    def __init__(self, lexicon: Lexicon, sil_phone: str = "SIL",
                 sil_prob: float = 0.5, optional_sil: bool = True,
                 extra_questions: Optional[List[List[str]]] = None,
                 position_dependent: bool = False):
        """``position_dependent`` rewrites every pronunciation with the
        prepare_lang.sh default _B/_E/_I/_S word-position suffixes
        (single-phone word → p_S; first → p_B; last → p_E; interior →
        p_I; silence stays bare), quadrupling the non-silence phone
        inventory — the tree questions then get position distinctions
        for free via word_position_groups()."""
        if position_dependent:
            rewritten = []
            for word, pron, prob in lexicon.normalized():
                if len(pron) == 1:
                    np_ = [pron[0] if pron[0] == sil_phone
                           else pron[0] + "_S"]
                else:
                    np_ = []
                    for i, p in enumerate(pron):
                        if p == sil_phone:
                            np_.append(p)
                        elif i == 0:
                            np_.append(p + "_B")
                        elif i == len(pron) - 1:
                            np_.append(p + "_E")
                        else:
                            np_.append(p + "_I")
                rewritten.append((word, np_, prob))
            lexicon = Lexicon(entries=rewritten)
        self.lexicon = lexicon
        self.position_dependent = position_dependent
        self.sil_phone = sil_phone
        self.sil_prob = sil_prob
        self.optional_sil = optional_sil

        # --- phone table: <eps>=0, SIL=1, then real phones, then disambig
        nonsil = [p for p in lexicon.phones() if p != sil_phone]
        self.phones = SymbolTable()
        self.phones.add("<eps>", 0)
        self.phones.add(sil_phone, 1)
        for p in nonsil:
            self.phones.add(p)
        self.silence_phones = [self.phones[sil_phone]]
        self.nonsilence_phones = [self.phones[p] for p in nonsil]

        # --- disambiguation symbols (add_lex_disambig.pl logic)
        self._num_disambig = self._count_disambig()
        # #0 is the LM backoff disambig; #1..#N the lexicon ones
        self.phone_disambig_start = max(self.phones.ids()) + 1
        self.disambig_ids: List[int] = []
        for k in range(0, self._num_disambig + 1):
            self.disambig_ids.append(
                self.phones.add(f"#{k}", self.phone_disambig_start + k))

        # --- word table: <eps>=0, words, #0, <s>, </s>
        self.words = SymbolTable()
        self.words.add("<eps>", 0)
        for w in lexicon.words():
            self.words.add(w)
        self.word_disambig = self.words.add("#0")
        self.words.add("<s>")
        self.words.add("</s>")

        self.L = self._make_lexicon_fst(with_disambig=False)
        self.L_disambig = self._make_lexicon_fst(with_disambig=True)

    # ------------------------------------------------------------------
    def _count_disambig(self) -> int:
        """How many #k symbols add_lex_disambig would create: count max
        multiplicity of repeated prons and prefix-prons."""
        prons: Dict[tuple, int] = {}
        prefixes = set()
        for _w, pron, _p in self.lexicon.normalized():
            t = tuple(pron)
            prons[t] = prons.get(t, 0) + 1
            for i in range(1, len(t)):
                prefixes.add(t[:i])
        max_k = 1  # always reserve #1
        for t, cnt in prons.items():
            need = cnt if cnt > 1 else (1 if t in prefixes else 0)
            max_k = max(max_k, need)
        return max_k

    def _disambig_assignment(self) -> List[int]:
        """Per lexicon entry: which #k to append (0 = none)."""
        prons: Dict[tuple, int] = {}
        prefixes = set()
        for _w, pron, _p in self.lexicon.normalized():
            t = tuple(pron)
            prons[t] = prons.get(t, 0) + 1
            for i in range(1, len(t)):
                prefixes.add(t[:i])
        seen_count: Dict[tuple, int] = {}
        out = []
        for _w, pron, _p in self.lexicon.normalized():
            t = tuple(pron)
            if prons[t] > 1 or t in prefixes:
                k = seen_count.get(t, 0) + 1
                seen_count[t] = k
                out.append(k)
            else:
                out.append(0)
        return out

    def _make_lexicon_fst(self, with_disambig: bool) -> VectorFst:
        """make_lexicon_fst.pl structure: loop state; optional silence
        after each word (prob sil_prob) and at utterance start."""
        fst = VectorFst()
        start = fst.add_state()
        loop = fst.add_state()
        sil_state = fst.add_state()
        fst.set_start(start)
        fst.set_final(loop, 0.0)
        sil = self.phones[self.sil_phone]
        sil_cost = -math.log(self.sil_prob) if self.optional_sil else 0.0
        no_sil_cost = (-math.log(1.0 - self.sil_prob)
                       if self.optional_sil else 0.0)
        # entry: either straight to loop (no initial sil) or through SIL
        fst.add_arc(start, Arc(EPS, EPS, no_sil_cost, loop))
        if self.optional_sil:
            fst.add_arc(start, Arc(sil, EPS, sil_cost, loop))
            # after-word silence
            fst.add_arc(sil_state, Arc(sil, EPS, 0.0, loop))
        # silence-disambig (#N is used for SIL in prepare_lang when needed;
        # we rely on the word-level structure being unambiguous instead)

        assignment = self._disambig_assignment()
        for (word, pron, prob), k in zip(self.lexicon.normalized(),
                                         assignment):
            wid = self.words[word]
            phones = [self.phones[p] for p in pron]
            if with_disambig and k > 0:
                phones = phones + [self.phones[f"#{k}"]]
            # pronunciation probability rides the first arc
            # (make_lexicon_fst.pl --pron-probs)
            pron_cost = -math.log(max(prob, 1e-10)) if prob < 1.0 \
                else 0.0
            cur = loop
            for i, ph in enumerate(phones):
                last = i == len(phones) - 1
                olab = wid if i == 0 else EPS
                w0 = pron_cost if i == 0 else 0.0
                if not last:
                    nxt = fst.add_state()
                    fst.add_arc(cur, Arc(ph, olab, w0, nxt))
                    cur = nxt
                else:
                    if self.optional_sil:
                        fst.add_arc(cur, Arc(ph, olab,
                                             w0 + no_sil_cost, loop))
                        fst.add_arc(cur, Arc(ph, olab,
                                             w0 + sil_cost, sil_state))
                    else:
                        fst.add_arc(cur, Arc(ph, olab, w0, loop))
        if with_disambig:
            # self-loop passing the LM backoff symbol #0 through L
            ph0 = self.phones["#0"]
            fst.add_arc(loop, Arc(ph0, self.word_disambig, 0.0, loop))
        return fst.arcsort("olabel")

    # ------------------------------------------------------------------
    def phone_list(self) -> List[int]:
        """Real phone ids (no ε, no disambig)."""
        return self.silence_phones + self.nonsilence_phones

    def mono_ilabel_info(self) -> List[Tuple[int, ...]]:
        """ilabel_info for context-width-1 graphs: CLG label i == phone i;
        disambig labels map to themselves."""
        max_id = max(self.phones.ids())
        return [(i,) for i in range(max_id + 1)]
