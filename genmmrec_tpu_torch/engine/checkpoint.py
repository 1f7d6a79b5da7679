"""Checkpoints with resume (counterpart of ``genmmrec_tpu/engine/checkpoint.py``).

The port's own format: one ``torch.save`` file, ``<path>.pt``, holding the
model's parameters, every optimizer's state, the model state (regenerated
graphs as dicts of tensors), the epoch and the best results. It is read back
with ``weights_only=True``, so it holds only tensors and plain Python
values. The JAX package's ``.ckpt`` pickles optax state, which needs JAX to
read, so the port does not read it; JAX parameters come across through
``interop.from_jax_params`` instead.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from genmmrec_tpu_torch.ops.graph import SparseGraph

_GRAPH_TAG = "__sparse_graph__"


def _pack(value):
    if isinstance(value, SparseGraph):
        return {_GRAPH_TAG: True, **{f.name: getattr(value, f.name) for f in dataclasses.fields(value)}}
    if isinstance(value, dict):
        return {k: _pack(v) for k, v in value.items()}
    return value


def _unpack(value):
    if isinstance(value, dict):
        if value.get(_GRAPH_TAG):
            return SparseGraph(**{k: v for k, v in value.items() if k != _GRAPH_TAG})
        return {k: _unpack(v) for k, v in value.items()}
    return value


def save_checkpoint(path: str, **entries: Any) -> str:
    """Write ``entries`` to ``<path>.pt``; returns the file's path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_pack(entries), path + ".pt")
    return path + ".pt"


def load_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    return _unpack(torch.load(path + ".pt", map_location=map_location, weights_only=True))
