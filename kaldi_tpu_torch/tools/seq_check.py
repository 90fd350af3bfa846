"""chip_smoke phase 18 alone, on one card.

    python3 kaldi_tpu_torch/tools/seq_check.py

Imports ``chip_smoke`` from this checkout, builds the kernels, then runs
what phase 18 takes its inputs from: phase 10b's mini ladder
(``mini_recipe``: 100 / 30 utterances of the ladder's corpus, the
tri3b stack on the card).  Then 18's worker (``seq_tools_start``: the
GMM decoders, keyword search and sequence training in a background
process) beside 17d's chain rung (``ladder_rung``), whose model 18b's
grammar decode reads, and the join (``seq_tools_finish``), as the whole
script runs them.  Card only (about 4 minutes).
"""

import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    import atexit
    import torch
    if not torch.cuda.is_available():
        print("seq_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.tools.timing import card_info
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{card_info()}]"
    print(f"seq_check: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__} {tag}", flush=True)
    build.load_all()
    t0 = time.perf_counter()
    _, _, m_wers, msys = cs.mini_recipe(dev, tag)
    seq = cs.seq_tools_start(dev, msys)
    atexit.register(cs._stop, seq[0])
    keep = {}
    cs.ladder_rung(dev, msys, m_wers, {s: m_wers[s].wer for s in m_wers},
                   tag, keep=keep)
    cs.seq_chain_ready(seq, keep)
    gmm, fb, den = cs.seq_tools_finish(seq, tag)
    print(f"seq_check: GMM launches {gmm}, fbank {fb}, den {den}; "
          f"{time.perf_counter() - t0:.1f} s after the build {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
