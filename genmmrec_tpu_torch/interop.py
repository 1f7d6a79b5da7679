"""Load the JAX package's parameter pytrees into the port's modules.

The JAX DiffMM keeps ``{"rec": {uEmbeds, iEmbeds, modal_weight,
image_trans, text_trans}, "denoise_image": {...}, "denoise_text": {...}}``
with linear layers as ``{"w": (d_out, d_in), "b": (d_out,)}`` and layer
stacks as lists. The port's parameter names are the same paths with the
``rec`` level dropped, ``w``/``b`` as ``weight``/``bias`` and list indices
as path parts. The leaves arrive as numpy arrays (``np.asarray`` of the JAX
arrays), so this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"w": "weight", "b": "bias"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (_LEAF_NAMES.get(k, k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


@torch.no_grad()
def from_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy every leaf of ``tree`` into the parameter of the same name.

    Raises if a parameter has no leaf, a leaf has no parameter, or shapes
    differ."""
    leaves = {}
    for path, leaf in _flatten(tree):
        if path and path[0] == "rec":
            path = path[1:]
        leaves[".".join(path)] = np.asarray(leaf)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(leaves))
    extra = sorted(set(leaves) - set(params))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        leaf = leaves[name]
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(leaf.shape)} != {tuple(p.shape)}")
        p.copy_(torch.tensor(leaf, dtype=p.dtype))
    return model
