# Port of kaldi_tpu/pipelines/checkpoint.py's reading side (latest_step,
# and restore_train_state as read_train_state), without jax or orbax.
"""The JAX package's training-state checkpoints, read without JAX.

The original saves ``{"step", "params", "batch_stats", "opt_state"}``
with orbax's ``StandardCheckpointer`` as ``<dir>/step_N`` (the
reference's per-iteration model files and --stage resume contract).
Such a directory holds ``_METADATA`` (JSON: one entry per leaf, its key
path with each key's type, 2 a dict key and 1 a sequence index, and its
value type) and an OCDBT key-value store in which each array leaf is a
zarr array named by its key path joined by dots
(``params.tdnnf1.linear.kernel``).  ``read_train_state`` opens each
leaf through ``tensorstore`` (the zarr driver over the OCDBT kvstore,
zarr3 where the metadata says so) into numpy trees: dicts for dict
nodes, lists for sequence nodes (optax's state tuples), ``None`` for the
leaves orbax writes no data for (optax's empty states).
``tensorstore`` is imported inside the function: the card's machine has
none, and there it raises a ``KaldiError`` that names it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError, get_logger

log = get_logger(__name__)


# Copied from kaldi_tpu/pipelines/checkpoint.py latest_step.
def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _listify(node):
    """Sequence nodes (marked by ``_seq``) → lists, recursively."""
    if not isinstance(node, dict):
        return node
    seq = node.pop("_seq", False)
    out = {k: _listify(v) for k, v in node.items()}
    if seq:
        return [out[k] for k in sorted(out, key=int)]
    return out


def read_train_state(path: str, step: Optional[int] = None
                     ) -> Dict[str, Any]:
    """``<path>/step_<step>`` (None: the latest) → ``{"step": int,
    "params", "batch_stats", "opt_state"}`` with numpy leaves."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise KaldiError("reading the JAX package's orbax checkpoints needs "
                         "the tensorstore package, which this Python does "
                         "not have") from e
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise KaldiError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step}")
    meta_path = os.path.join(d, "_METADATA")
    if not os.path.exists(meta_path):
        raise KaldiError(f"{d}: no _METADATA (not an orbax checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True):
        raise KaldiError(f"{d}: only OCDBT checkpoints are read")
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    kvstore = {"driver": "ocdbt", "base": f"file://{d}/"}
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = tree
        for k, nxt in zip(keys[:-1], keys[1:]):
            node = node.setdefault(k["key"], {})
            if nxt["key_type"] == 1:
                node["_seq"] = True
        if keys[0]["key_type"] == 1:
            tree["_seq"] = True
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            leaf = None
        else:
            name = ".".join(k["key"] for k in keys)
            leaf = np.asarray(ts.open({"driver": driver, "kvstore": kvstore,
                                       "path": name}, open=True,
                                      read=True).result().read().result())
        node[keys[-1]["key"]] = leaf
    tree = _listify(tree)
    log.info("checkpoint: read step %d from %s", step, path)
    tree["step"] = int(np.asarray(tree["step"]))
    return tree
