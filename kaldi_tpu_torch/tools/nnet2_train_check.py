"""chip_smoke phase 23 alone, on one card.

    python3 kaldi_tpu_torch/tools/nnet2_train_check.py

Imports ``chip_smoke`` from this checkout, builds the kernels, then runs
what phase 23 takes its inputs from: phase 10b's mini ladder
(``mini_recipe``: 100 / 30 utterances of the ladder's corpus, the tri3b
stack on the card) written as phase 22's inputs (``nnet_loop_write``).
Then 23's worker (``nnet2_train_start``: the nnet2 training recipe and
utils/' data-directory tools as tools, in a background process) and the
join (``nnet2_train_finish``), as the whole script runs them.  Phase 22
itself does not run.  Card only.
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
        print("nnet2_train_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.tools.timing import card_info
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{card_info()}]"
    print(f"nnet2_train_check: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__} {tag}", flush=True)
    build.load_all()
    t0 = time.perf_counter()
    _, _, m_wers, msys = cs.mini_recipe(dev, tag)
    started = cs.nnet2_train_start(cs.nnet_loop_write(msys, m_wers), dev)
    atexit.register(cs._stop, started[0])
    fb, err = cs.nnet2_train_finish(started, tag)
    print(f"nnet2_train_check: fbank launches {fb}, kernel vs plain "
          f"{err:.3e}; {time.perf_counter() - t0:.1f} s after the build "
          f"{tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
