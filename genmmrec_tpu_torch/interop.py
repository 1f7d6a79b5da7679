"""Move parameters between the JAX package's pytrees and the port's modules.

The graph-CF models keep a flat or lightly nested tree, ``{user_emb,
item_emb}`` (BPR, LightGCN), ``{user_embeddings, item_embeddings}``
(LayerGCN), ``{"encoder": {user_emb, item_emb}, "predictor": {w, b}}``
(SELFCFED_LGN), and the port's parameters carry the same paths. The JAX
DiffMM keeps ``{"rec": {uEmbeds, iEmbeds, modal_weight,
image_trans, text_trans}, "denoise_image": {...}, "denoise_text": {...}}``
with linear layers as ``{"w": (d_out, d_in), "b": (d_out,)}`` and layer
stacks as lists; GenRecV1 keeps ``{"rec": {...}, "denoise_image": {...}}``
with its normalizations as ``{"g", "b"}`` (batch norms under ``rec``, the
denoiser's layer norms, ``out_ln``) and a bare leaf ``ca_bv`` a layer. The
port's parameter names are the same paths with the ``rec`` level dropped,
``w``/``b`` as ``weight``/``bias`` (so a normalization holds ``g`` and
``bias``, ``common.norm.Norm``) and list indices as path parts. The leaves arrive as numpy arrays (``np.asarray`` of the JAX
arrays), so this module imports nothing of JAX.

``jax_tree_by_name`` and ``params_by_jax_name`` flatten the two sides into
one naming, ``"rec/uEmbeds"``, ``"denoise_image/in_layers/0/w"``, so that
parameters can be compared leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"w": "weight", "b": "bias"}
_JAX_LEAF_NAMES = {v: k for k, v in _LEAF_NAMES.items()}
# top-level subtrees of a JAX tree that has them; every other parameter of
# such a model sits under "rec"
_TOP_LEVEL = ("denoise_image", "denoise_text")


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


def jax_tree_by_name(tree) -> dict:
    """``{"rec/uEmbeds": array, ...}`` from a JAX parameter pytree."""
    out = {}
    for path, leaf in _flatten(tree):
        parts = list(path[:-1]) + [_JAX_LEAF_NAMES.get(path[-1], path[-1])]
        out["/".join(parts)] = np.asarray(leaf)
    return out


def params_by_jax_name(model: nn.Module) -> dict:
    """The model's parameters as numpy arrays under the JAX tree's names."""
    named = dict(model.named_parameters())
    has_rec_level = any(name.split(".")[0] in _TOP_LEVEL for name in named)
    out = {}
    for name, p in named.items():
        parts = name.split(".")
        parts[-1] = _JAX_LEAF_NAMES.get(parts[-1], parts[-1])
        if has_rec_level and parts[0] not in _TOP_LEVEL:
            parts = ["rec"] + parts
        out["/".join(parts)] = p.detach().cpu().numpy()
    return out
