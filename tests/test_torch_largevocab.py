"""The port's large-vocabulary decode CLI, end to end at a tiny size on
the CPU (``--device=cpu``): task build, batched lattice decode, WER."""

import torch

from kaldi_tpu_torch.pipelines import largevocab as tlv

torch.set_num_threads(1)


def test_largevocab_cli_runs_on_cpu(capsys):
    assert tlv.main(["--vocab=200", "--num-utts=4", "--device=cpu",
                     "--max-active=500"]) == 0
    out = capsys.readouterr().out
    assert "%WER 0.00" in out          # noise 0.5 on this task: no errors
    assert "audio-s/s" in out
