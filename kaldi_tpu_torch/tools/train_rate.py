"""Chain training's rate at chip_smoke phase 8b's points, for one tree.

    python kaldi_tpu_torch/tools/train_rate.py [--root=DIR] [--steps=30]
        [--points=32:float32,32:bfloat16,...] [--models=tdnn,xc_tdnnf]
        [--rounds=1]

Imports ``chip_smoke`` and ``kaldi_tpu_torch`` from ``--root`` (default:
this checkout), builds that tree's kernels, and runs its phase 8b: the
48 seeded waveforms' egs on the bench's den graph, then ChainTrainer
with NG-SGD at each of its (B, dtype) points (or those of
``--points``), ``--steps`` timed steps a point after 3 warm ones.
``--models`` names the models, each measured at every point in turn,
``--rounds`` times over: ``tdnn`` is 8b's TdnnChain, ``xc_tdnnf`` and
``xc_full`` phase 15a's xconfig models (float32 only).  Run
as a script (not ``-m``) so that a second checkout, such as a parent
commit unpacked under ``build/``, is measured by its own code: run
parent, change, change, parent in one session on one card to compare
two trees.  Prints one JSON line with the root, the
card and Mframes/s a point.  Card only.
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
    steps = int(opts.get("steps", 30))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("train_rate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from kaldi_tpu_torch.ops import build
    from kaldi_tpu_torch.tools.timing import card_info
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_info()
    t0 = time.perf_counter()
    build.load_all()
    topo, tree, _, den = cs.bench_den_graph()
    egs = cs.chain_egs(dev, topo, tree, den, 48)[0]
    points = cs.CHAIN_POINTS
    if "points" in opts:
        points = tuple((int(b), d) for b, d in
                       (p.split(":") for p in opts["points"].split(",")))
    rates = {}
    for r in range(int(opts.get("rounds", 1))):
        for m in opts.get("models", "tdnn").split(","):
            rates.update(cs.chain_train_points(
                dev, den, egs, tree.num_pdfs, f"[{card}]", points=points,
                steps=steps, key_prefix=f"{m}_r{r}_" if "models" in opts
                else "", model=None if m == "tdnn" else cs.xconfig_model(m)))
    print(json.dumps({"root": root, "card": card, "steps": steps,
                      "Mframes_s": rates,
                      "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
