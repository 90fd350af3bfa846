"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch

from kaldi_tpu_torch.core.logging import KaldiError


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device.  A CUDA device on a host with no
    card raises: nothing goes on on the CPU unless asked to
    (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KaldiError(f"device {dev}: no CUDA card is available "
                         "(pass device='cpu' to run on the CPU)")
    return dev
