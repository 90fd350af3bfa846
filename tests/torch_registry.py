"""The number of tools the port's registry holds
(``kaldi_tpu_torch.cli.TOOLS``), read by every test that counts them:
304 of the original's 526 names since the nnet2 training tools and the
data-directory tools (tests/test_torch_nnet2_train_tools.py,
tests/test_torch_datadir_tools.py)."""

TOOL_COUNT = 304
