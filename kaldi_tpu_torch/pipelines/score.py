"""Copy of kaldi_tpu/pipelines/score.py: WER via Levenshtein alignment.

Its ``WerStats``, ``edit_distance``, ``compute_wer`` (parity target
src/bin/compute-wer.cc) and ``wilson_interval`` (the WER ladder's error
bars), copied: that module
is jax-free itself, but importing it loads ``kaldi_tpu.pipelines``,
whose package imports JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class WerStats:
    errors: int = 0
    ins: int = 0
    dels: int = 0
    subs: int = 0
    ref_words: int = 0
    num_utts: int = 0
    sentence_errors: int = 0

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_words, 1)

    @property
    def ser(self) -> float:
        return 100.0 * self.sentence_errors / max(self.num_utts, 1)

    def __str__(self) -> str:
        return (f"%WER {self.wer:.2f} [ {self.errors} / {self.ref_words}, "
                f"{self.ins} ins, {self.dels} del, {self.subs} sub ] "
                f"%SER {self.ser:.2f} [ {self.sentence_errors} / "
                f"{self.num_utts} ]")


def edit_distance(ref: Sequence[str], hyp: Sequence[str]
                  ) -> Tuple[int, int, int, int]:
    """(total, ins, del, sub) via DP with backtrace."""
    R, H = len(ref), len(hyp)
    dp = [[(0, 0, 0, 0)] * (H + 1) for _ in range(R + 1)]
    for j in range(1, H + 1):
        dp[0][j] = (j, j, 0, 0)
    for i in range(1, R + 1):
        dp[i][0] = (i, 0, i, 0)
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                dp[i][j] = dp[i - 1][j - 1]
                continue
            sub = dp[i - 1][j - 1]
            dl = dp[i - 1][j]
            ins = dp[i][j - 1]
            dp[i][j] = min((sub[0] + 1, sub[1], sub[2], sub[3] + 1),
                           (dl[0] + 1, dl[1], dl[2] + 1, dl[3]),
                           (ins[0] + 1, ins[1] + 1, ins[2], ins[3]))
    return dp[R][H]


def compute_wer(refs: Dict[str, List[str]], hyps: Dict[str, List[str]]
                ) -> WerStats:
    stats = WerStats()
    for key, ref in refs.items():
        tot, ins, dels, subs = edit_distance(ref, hyps.get(key, []))
        stats.errors += tot
        stats.ins += ins
        stats.dels += dels
        stats.subs += subs
        stats.ref_words += len(ref)
        stats.num_utts += 1
        if tot > 0:
            stats.sentence_errors += 1
    return stats


# Copied from kaldi_tpu/pipelines/score.py wilson_interval.
def wilson_interval(errors: int, total: int, z: float = 1.96
                    ) -> Tuple[float, float]:
    """95% Wilson score interval for an error PROPORTION, in percent —
    the statistical-power annotation for small WER evals (treats word
    errors as Bernoulli; correlated within-utterance errors make the
    true interval somewhat wider, so read it as a lower bound on the
    uncertainty)."""
    if total <= 0:
        return (0.0, 100.0)
    p = errors / total
    denom = 1.0 + z * z / total
    center = (p + z * z / (2 * total)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / total
                                   + z * z / (4 * total * total))
    return (100.0 * max(0.0, center - half),
            100.0 * min(1.0, center + half))
