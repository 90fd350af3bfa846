"""Run-to-run spread of the flagship's chain rungs on the card, with the
chain trainings in float32 under deterministic algorithms.

    python -m kaldi_tpu_torch.tools.flagship_spread

Runs pipelines/flagship.py ``run`` at its ``R05_POINT`` (chip_smoke.py
11a's operating point; no MBR row) RUNS times from the same seed in
one process, with ``chain_dtype="float32"``, a fixed cuBLAS workspace
(``CUBLAS_WORKSPACE_CONFIG``, set before the card is first used) and
``torch.use_deterministic_algorithms(True, warn_only=True)``.  Prints
one JSON line per run with both chain rungs' (``chain-tdnn``,
``chain-tdnn+ivec``) WER, oracle WER, escalations, least effective beam
and objective, then one line with the spread (largest − smallest) of
each across the runs and the operations PyTorch warned have no
deterministic CUDA version.  Two runs that agree show that what the
default settings (bfloat16, atomic sums) spread is their run-to-run
nondeterminism; chip_smoke.py 11a runs the default settings.  Card
only: without one it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import sys
import time
import warnings

import torch

from kaldi_tpu_torch.core.options import ParseOptions

RUNS = 2
RUNGS = ("chain-tdnn", "chain-tdnn+ivec")
KEYS = ("wer", "oracle_wer", "n_escalated", "min_eff_beam", "objf")


def main(argv=None) -> int:
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.tools.flagship_spread")
    po.read(argv)
    if not torch.cuda.is_available():
        print("flagship_spread: no CUDA device; nothing to run",
              file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    from kaldi_tpu_torch.pipelines import flagship
    from kaldi_tpu_torch.tools.timing import card_info
    card = card_info()
    rows = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(RUNS):
            t0 = time.perf_counter()
            results = flagship.run(device="cuda", chain_dtype="float32",
                                   with_mbr=False, **flagship.R05_POINT)
            by = {r["system"]: r for r in results}
            row = {"run": i, "wall_s": round(time.perf_counter() - t0, 1),
                   "card": card}
            for rung in RUNGS:
                row[rung] = {k: by[rung].get(k) for k in KEYS}
            rows.append(row)
            print(json.dumps(row), flush=True)
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught
                     if "deterministic" in str(w.message)})
    spread = {rung: {k: round(max(r[rung][k] for r in rows)
                              - min(r[rung][k] for r in rows), 3)
                     for k in KEYS} for rung in RUNGS}
    print(json.dumps({"spread": spread, "runs": len(rows),
                      "no_deterministic_version": nondet, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
