"""chip_smoke phase 21 alone, on one card.

    python3 kaldi_tpu_torch/tools/nnet2_check.py

Imports ``chip_smoke`` from this checkout, builds the kernels, then
writes what phase 21 takes its inputs from, as the whole script writes
them: phase 7d's 300-word task (its .mdl and HCLG in
build/chip_smoke_online2) and phase 20's 8 seeded waveforms
(build/chip_smoke_serve/wav8.ark).  Then 21's worker
(``nnet2_tools_start``: the nnet2 tools in a background process) and the
join (``nnet2_tools_finish``), as the whole script runs them.  Card only
(about 3 minutes).
"""

import os
import sys
import time


def write_inputs(cs, task300) -> None:
    """7d's .mdl and HCLG and 20's waveforms, as chip_smoke writes them
    (``online2_cli``, ``serve_tools_write``)."""
    import numpy as np
    from kaldi_tpu_torch.am.gmm import AmDiagGmm
    from kaldi_tpu_torch.am.serialize import write_mdl
    from kaldi_tpu_torch.core.table import TableWriter
    from kaldi_tpu_torch.fst.csr import csr_to_vector_fst
    from kaldi_tpu_torch.fst.openfst_io import write_fst_path
    repo = os.path.dirname(os.path.abspath(cs.__file__))
    o2 = os.path.join(repo, "build", "chip_smoke_online2")
    sv = os.path.join(repo, cs.SERVE_DIR)
    os.makedirs(o2, exist_ok=True)
    os.makedirs(sv, exist_ok=True)
    P = task300.num_pdfs
    write_mdl(f"{o2}/final.mdl", task300.tm,
              AmDiagGmm(np.ones((P, 1)), np.zeros((P, 1, 13)),
                        np.ones((P, 1, 13)), device="cpu"))
    write_fst_path(f"{o2}/HCLG.fst", csr_to_vector_fst(task300.graph.csr))
    waves = cs.speech_set(task300, cs.SERVE_WAVES, cs.SEED + 8)[0]
    with TableWriter(f"ark:{sv}/wav8.ark", holder="wav") as w:
        for i, x in enumerate(waves):
            w[f"utt{i}"] = (cs._int16(x), cs.SAMP_FREQ)


def main() -> int:
    sys.path.insert(0, os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "..")))
    import atexit
    import torch
    if not torch.cuda.is_available():
        print("nnet2_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import kaldi_tpu_torch.features  # noqa: F401  (before ops.fbank)
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.pipelines.largevocab import make_largevocab_task
    from kaldi_tpu_torch.tools.timing import card_info
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{card_info()}]"
    print(f"nnet2_check: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__} {tag}", flush=True)
    build.load_all()
    t0 = time.perf_counter()
    task300 = make_largevocab_task(vocab_size=300, order=3, seed=7,
                                   closure=False, corpus_sentences=600)
    write_inputs(cs, task300)
    started = cs.nnet2_tools_start(cs.nnet2_tools_write(task300), dev)
    atexit.register(cs._stop, started[0])
    fb, err = cs.nnet2_tools_finish(started, tag)
    print(f"nnet2_check: fbank launches {fb}, kernel vs plain {err:.3e}; "
          f"{time.perf_counter() - t0:.1f} s after the build {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
