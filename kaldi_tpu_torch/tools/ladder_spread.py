"""Run-to-run spread of the mini ladder on the card, for one tree.

    python kaldi_tpu_torch/tools/ladder_spread.py [--root=DIR] [--runs=4]

Imports ``chip_smoke`` and ``kaldi_tpu_torch`` from ``--root`` (default:
this checkout), builds that tree's kernels, and runs chip_smoke phase
10b's mini ladder (``pipelines/mini.py`` on the ladder's hard corpus at
``chip_smoke.MINI_LADDER``) ``--runs`` times in one process: each run's
WER per stage, its last log-likelihood per frame per stage (to full
precision: two runs that sum in the same order print the same digits)
and its wall.  Run as a script (not ``-m``) so that a parent commit
unpacked under ``build/`` is measured by its own code.  Prints one JSON
line with the root, the card and every run.  Card only.
"""

import json
import os
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    root = os.path.abspath(opts.get("root", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("ladder_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.pipelines import mini
    from kaldi_tpu_torch.pipelines.data import (confusable_formants,
                                                confusable_lexicon)
    from kaldi_tpu_torch.tools.timing import card_info
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_info()
    build.load_all()
    runs = []
    for i in range(int(opts.get("runs", 4))):
        last = {}

        def report(stage, it, ali, accs):
            last[stage] = accs.tot_like / accs.tot_frames

        t0 = time.perf_counter()
        wers = mini.run(lexicon=confusable_lexicon(),
                        formants=confusable_formants(), device=dev,
                        report=report, **cs.MINI_LADDER)
        torch.cuda.synchronize()
        runs.append({"wer": {k: v.wer for k, v in wers.items()},
                     "loglike": {k: repr(v) for k, v in last.items()},
                     "wall_s": time.perf_counter() - t0})
        print(f"ladder_spread: run {i}: "
              + "; ".join(f"{k} {v.wer:.2f}" for k, v in wers.items())
              + f"; tri3b ≤ mono: {wers['tri3b'].wer <= wers['mono'].wer} "
              f"[{card}]")
    print(json.dumps({"root": root, "card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
