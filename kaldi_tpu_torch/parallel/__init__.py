"""Parallelism: meshes of ranks, shardings, collectives.

Port of kaldi_tpu/parallel/__init__.py.  Where Kaldi shards work as
filesystem jobs glued by run.pl/queue.pl and reduces via gmm-sum-accs /
nnet3-average, the port runs one process per card joined by
``torch.distributed``, lays the ranks out as a (data, model) mesh and
sums with ``all_reduce``.
"""

from kaldi_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    model_sharding_rules,
    shard_params,
    replicate,
)

__all__ = ["make_mesh", "batch_sharding", "model_sharding_rules",
           "shard_params", "replicate"]
