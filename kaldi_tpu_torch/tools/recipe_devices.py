"""Where the chain CLI recipe's runs on two devices part.

    python -m kaldi_tpu_torch.tools.recipe_devices [--work-dir=DIR]
        [--runs=cuda,cuda,cpu] [--out=chiprun_out/recipe_devices.json]
        [--num-utts=40] [--num-test=12] [--mono-iters=8]
        [--chain-epochs=8] [--hidden=48] [--cross=true]
        [--against=DIR]

Runs ``pipelines/chain_cli_recipe.py`` once a device in ``--runs`` (the
same seeds), each in a work dir of its own, and holds every later run's
stage outputs against the first's: the MFCC and final features, the mono
GMM's alignments and model, the phone supervision, the egs (bytes, then
features and pdf labels), the initial and trained networks, the WER and
the words.  When the runs hold both a card and the CPU (and ``--cross``)
it then crosses them, each result decoded with the recipe's own stage 7
and 8 tools: the card trains on the CPU run's egs and the CPU on the
card run's; the CPU run's network is decoded on the card and the card
run's on the CPU.  Every trained network's chain objective is computed
on the first run's egs on the CPU.  Prints one line a comparison and
writes all of it as JSON to ``--out``.  ``--against=DIR`` instead holds
the existing first run against a run dir made elsewhere (another
machine's, unpacked at the path it had there) and runs nothing.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import torch

from kaldi_tpu_torch.core.logging import KaldiError
from kaldi_tpu_torch.core.options import ParseOptions
from kaldi_tpu_torch.core.table import SequentialTableReader


def _tool(name, argv):
    from kaldi_tpu_torch.cli import TOOLS
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TOOLS[name](argv)
    if rc:
        raise KaldiError(f"{name} failed (rc={rc})")
    return out.getvalue()


def _table(spec, holder):
    return {k: np.asarray(v) for k, v in SequentialTableReader(spec,
                                                              holder=holder)}


def _max_diff(a, b) -> float:
    if sorted(a) != sorted(b):
        return float("inf")
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               if a[k].shape == b[k].shape else float("inf") for k in a)


def _bytes_equal(p, q) -> bool:
    with open(p, "rb") as f, open(q, "rb") as g:
        return f.read() == g.read()


def _net(path):
    from kaldi_tpu_torch.am.nnet3_io import (infer_tdnn_config,
                                             nnet3_to_state_dict,
                                             read_nnet3_path)
    model = read_nnet3_path(path)
    return nnet3_to_state_dict(model, infer_tdnn_config(model))


def _hyps(tra):
    return {k: list(v) for k, v in SequentialTableReader(f"ark,t:{tra}",
                                                         holder="text")}


def decode(work, raw, device, out_dir):
    """The recipe's stages 7 and 8 on ``raw`` with ``work``'s graph and
    test features → (WER, words, seconds)."""
    from kaldi_tpu_torch.pipelines.datadir import read_data_dir
    from kaldi_tpu_torch.pipelines.score import compute_wer
    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    c = os.path.join(work, "exp", "chain")
    lat = os.path.join(out_dir, "lat.ark")
    tra = os.path.join(out_dir, "tra.txt")
    words = os.path.join(work, "lang", "words.txt")
    _tool("nnet3-latgen-faster", [
        "--beam=16.0", "--acoustic-scale=1.0",
        "--frame-subsampling-factor=3", f"--device={device}",
        f"--word-symbol-table={words}", f"{c}/0.mdl", raw,
        f"{c}/graph/HCLG.fst", f"scp:{work}/mfcc/final_test.scp",
        f"ark:{lat}"])
    _tool("lattice-best-path", [f"--word-symbol-table={words}",
                                f"ark:{lat}", f"ark,t:{tra}"])
    hyps = _hyps(tra)
    wer = compute_wer(read_data_dir(os.path.join(work, "data", "test")).text,
                      hyps)
    return wer, hyps, time.perf_counter() - t0


def train(work, device, raw_out, epochs):
    """The recipe's stage 5 training on ``work``'s egs on ``device``."""
    c = os.path.join(work, "exp", "chain")
    _tool("nnet3-chain-train", [
        f"--num-epochs={epochs}", "--learning-rate=2e-3", "--lm-order=2",
        f"--device={device}", f"{c}/0.mdl", f"{c}/0.raw",
        f"ark:{c}/phones.ark", f"ark:{c}/egs.ark", raw_out])


def objf(work, raw) -> float:
    """nnet3-chain-compute-prob of ``raw`` on ``work``'s egs, on the CPU."""
    c = os.path.join(work, "exp", "chain")
    return float(_tool("nnet3-chain-compute-prob", [
        "--lm-order=2", "--device=cpu", f"{c}/0.mdl", raw,
        f"ark:{c}/phones.ark", f"ark:{c}/egs.ark"]).split()[-1])


def compare(a, b) -> dict:
    """Stage by stage, run dir ``b`` against run dir ``a``."""
    from kaldi_tpu_torch.am.serialize import read_mdl
    from kaldi_tpu_torch.pipelines.egs_io import read_egs_ark
    out = {}
    for name in ("raw_mfcc_train", "raw_mfcc_test", "final_train",
                 "final_test"):
        out[f"{name}_max_abs_diff"] = _max_diff(*(
            _table(f"scp:{w}/mfcc/{name}.scp", "mat") for w in (a, b)))
    mono = os.path.join("exp", "mono")
    for f in sorted(os.listdir(os.path.join(a, mono))):
        if f.startswith("ali.") and f.endswith(".ark"):
            x, y = (_table(f"ark:{w}/{mono}/{f}", "ivec") for w in (a, b))
            out[f"{f}_frames_differing"] = int(sum(
                int((x[k] != y[k]).sum()) if x[k].shape == y[k].shape
                else len(x[k]) for k in x))
    ma, mb = (read_mdl(f"{w}/{mono}/final.mdl", device="cpu")[1]
              for w in (a, b))
    out["mono_mdl_means_max_abs_diff"] = float(
        np.abs(ma.means - mb.means).max())
    c = os.path.join("exp", "chain")
    x, y = (_table(f"ark:{w}/{c}/phones.ark", "ivec") for w in (a, b))
    out["phones_utts_differing"] = sum(
        int(x[k].shape != y[k].shape or bool((x[k] != y[k]).any()))
        for k in x)
    for f in ("egs.raw.ark", "egs.ark", "0.raw"):
        out[f"{f}_bytes_equal"] = _bytes_equal(f"{a}/{c}/{f}", f"{b}/{c}/{f}")
    ea, eb = (read_egs_ark(f"ark:{w}/{c}/egs.ark") for w in (a, b))
    out["egs"] = [ea.feats.shape[0], eb.feats.shape[0]]
    if ea.feats.shape == eb.feats.shape:
        out["egs_feats_max_abs_diff"] = float(
            np.abs(ea.feats - eb.feats).max())
        out["egs_pdf_labels_differing"] = int(
            (ea.pdf_ali != eb.pdf_ali).sum())
    na, nb = (_net(f"{w}/{c}/final.raw") for w in (a, b))
    out["final_raw_max_abs_diff"] = max(
        float((na[k] - nb[k]).abs().max()) for k in na)
    return out


def main(argv=None) -> int:
    from kaldi_tpu_torch.pipelines.chain_cli_recipe import run
    po = ParseOptions("Usage: python -m kaldi_tpu_torch.tools.recipe_devices")
    po.register("work-dir", str, "build/recipe_devices", "working directory")
    po.register("runs", str, "cuda,cuda,cpu", "one recipe run a device")
    po.register("out", str, "chiprun_out/recipe_devices.json", "JSON out")
    po.register("num-utts", int, 40, "training utterances")
    po.register("num-test", int, 12, "test utterances")
    po.register("mono-iters", int, 8, "mono iterations")
    po.register("chain-epochs", int, 8, "chain training epochs")
    po.register("hidden", int, 48, "TDNN-F width")
    po.register("cross", bool, True, "cross a card run with a CPU run")
    po.register("against", str, "", "compare run 0 with this run dir")
    po.read(argv)
    if po["against"]:
        w = os.path.abspath(os.path.join(po["work-dir"], "run0_" +
                                         po["runs"].split(",")[0]))
        cmp = compare(w, os.path.abspath(po["against"]))
        print(f"recipe_devices: {po['against']} against {w}: "
              f"{json.dumps(cmp)}")
        return 0
    runs = po["runs"].split(",")
    if "cuda" in runs and not torch.cuda.is_available():
        raise KaldiError("recipe_devices: no CUDA card for a cuda run")
    size = dict(num_utts=po["num-utts"], num_test=po["num-test"],
                mono_iters=po["mono-iters"], chain_epochs=po["chain-epochs"],
                hidden=po["hidden"])
    rec = {"size": size, "runs": [], "compare": {}, "cross": {},
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    dirs = []
    for i, device in enumerate(runs):
        w = os.path.abspath(os.path.join(po["work-dir"], f"run{i}_{device}"))
        dirs.append(w)
        stage_s = {}
        t0 = time.perf_counter()
        wer = run(w, device=device, stage_s=stage_s, **size)
        raw = f"{w}/exp/chain/final.raw"
        rec["runs"].append({
            "device": device, "wer": wer.wer, "wer_text": str(wer),
            "wall_s": time.perf_counter() - t0, "stage_s": stage_s,
            "objf_on_run0_egs": objf(dirs[0], raw),
            "objf_own_egs": objf(w, raw)})
        print(f"recipe_devices: run {i} ({device}): {wer}; objf on run 0's "
              f"egs {rec['runs'][-1]['objf_on_run0_egs']:.6f}")
        if i:
            cmp = compare(dirs[0], w)
            cmp["words_equal"] = (_hyps(f"{dirs[0]}/exp/chain/decode_test/"
                                        "tra.txt")
                                  == _hyps(f"{w}/exp/chain/decode_test/"
                                           "tra.txt"))
            rec["compare"][f"run{i}_vs_run0"] = cmp
            print(f"recipe_devices: run {i} ({device}) against run 0 "
                  f"({runs[0]}): {json.dumps(cmp)}")
    if po["cross"] and "cuda" in runs and "cpu" in runs:
        card, cpu = (dirs[runs.index(d)] for d in ("cuda", "cpu"))
        epochs = po["chain-epochs"]
        x = os.path.abspath(os.path.join(po["work-dir"], "cross"))
        os.makedirs(x, exist_ok=True)
        cases = (("cpu_egs_trained_on_card", cpu, "cuda", True),
                 ("card_egs_trained_on_cpu", card, "cpu", True),
                 ("cpu_model_decoded_on_card", cpu, "cuda", False),
                 ("card_model_decoded_on_cpu", card, "cpu", False))
        for name, w, device, trains in cases:
            raw = f"{w}/exp/chain/final.raw"
            if trains:
                raw = f"{x}/{name}.raw"
                train(w, device, raw, epochs)
            wer, hyps, sec = decode(w, raw, device, f"{x}/{name}")
            rec["cross"][name] = {
                "wer": wer.wer, "wer_text": str(wer), "decode_s": sec,
                "objf_on_run0_egs": objf(dirs[0], raw),
                "words_equal_card_run": hyps == _hyps(
                    f"{card}/exp/chain/decode_test/tra.txt"),
                "words_equal_cpu_run": hyps == _hyps(
                    f"{cpu}/exp/chain/decode_test/tra.txt")}
            print(f"recipe_devices: {name}: {json.dumps(rec['cross'][name])}")
    os.makedirs(os.path.dirname(os.path.abspath(po["out"])), exist_ok=True)
    with open(po["out"], "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
