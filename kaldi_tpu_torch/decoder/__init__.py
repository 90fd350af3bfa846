"""Decoders (reference L7: src/decoder/ + the fork's GPU decoder).

``SimpleDecoder`` (decoder/simple.py, the host oracle) is exported here,
as the original's package does; the tensor decoders (beam.py, dense.py,
online_beam.py) are imported from their modules."""

from kaldi_tpu_torch.decoder.simple import SimpleDecoder

__all__ = ["SimpleDecoder"]
