"""Move parameters between the JAX package's pytrees and the port's modules.

The graph-CF models keep a flat or lightly nested tree, ``{user_emb,
item_emb}`` (BPR, LightGCN), ``{user_embeddings, item_embeddings}``
(LayerGCN), ``{"encoder": {user_emb, item_emb}, "predictor": {w, b}}``
(SELFCFED_LGN), ``{user_embedding, item_id_embedding, predictor: {w, b},
image_embedding, image_trs: {w, b}, text_embedding, text_trs: {w, b}}``
(BM3; FREEDOM without the predictor and the two tables), ``{u_embedding,
i_embedding, item_linear: {w, b}}`` (VBPR), ``{dummy_embeddings}``
(ItemKNNCBF), and the port's parameters carry the same paths. The
message-passing models nest their towers and keep bare leaves beside the
linear layers: ``{id_embedding, v_gcn: {preference, conv1_w, lin1: {w, b},
g1: {w, b}, ..., mlp: {w, b}}, t_gcn: {...}}`` (MMGCN; ``conv{i}_w`` is
(in, out), applied as ``x @ W``), ``{id_embedding, v_preference, v_mlp:
{w, b}, t_preference, t_mlp, model_specific_conf}`` (GRCN),
``{v_preference, v_mlp, v_mlp1, t_preference, t_mlp, t_mlp1, weight_u (U,
2, 1), weight_i}`` (DualGNN, DRAGON), ``{id_feat, id_gcn: {preference,
mlp, mlp1}, v_gcn, t_gcn, weight_u}`` (COHESION), ``{collaborative,
v_gcn: {preference, mlp, conv1: {w (in, out), b}, g1, conv2, g2, conv4,
lin4, g4, conv5, lin5, g5}, t_gcn, c_gcn}`` (MVGAE; a ``conv`` is not an
``nn.Linear``, so its ``weight`` keeps the (in, out) layout). The last
multimodal graph models keep flat trees of tables and ``{w (out, in), b}``
linear layers (``nn.Linear``'s layout, applied as ``x @ Wᵀ + b``; a
layer without bias has ``w`` alone): ``{user_embedding,
item_id_embedding, extended_image_user, extended_text_user, image_reduce,
image_trans, text_reduce, text_trans, separate1, separate2,
image_behavior, text_behavior}`` (GUME), ``{user_embedding,
item_id_embedding, modal_weight, image_trs, text_trs}`` (LATTICE),
``{..., image_trs, text_trs, query1, query2, gate_v, gate_t,
gate_image_prefer, gate_text_prefer}`` (MGCN), ``{user_embedding,
item_id_embedding, item_image_trs, v_hyper, item_text_trs, t_hyper}``
(LGMRec; the four feature matrices are bare (in, out) leaves applied as
``x @ W``), MGCN's plus ``{query_v: {l1, l2}, query_t, gate_f,
gate_fusion_prefer, image_complex_weight (1, d/2+1, 2), ...}`` (SMORE),
``{user_image, user_text, image_trs, text_trs}`` (PGL),
``{embedding_user, embedding_item, v_dense, t_dense, user_after,
item_after, g_i_iv, g_v_iv, g_iv_iva, g_a_iva, g_iva_ivat, g_t_ivat}``
(SLMRec), ``{user_embedding, item_id_embedding}`` (DAMRS). The JAX
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

The diffusion models keep flat trees of tables and ``{w, b}`` layers
(``nn.Linear``'s layout) with their denoisers nested: ``{dnn: {emb_layer,
in_layers, out_layers}}`` (DiffRec), ``{mm_project, item_proj, cond_proj,
time_proj, output_proj, t_in, layers: [{ln: {g, b}, l1, l2, scale,
shift}]}`` (LD4MRec), ``{user_emb, item_emb, user_reverse, item_reverse}``
(DDRM), ``{user_emb, item_emb, usr_denoiser, item_denoiser}``
(DiffGraph), ``{user_emb, item_emb, unet: {enc1: {c1: {w (O, I, 3, 3), b},
bn1, c2, bn2}, enc2, dec1, final, time1, time2}, v_mlp, t_mlp}`` (MCDRec;
a convolution's ``w`` is ``nn.Conv2d``'s OIHW weight), ``{user_emb,
item_emb, uinterest_emb, user_emb_text, item_text_net: {w}, encodecon1:
{l1, l2}, encodecon2, non: {emb_layer, in, ln, out}, cdn: {emb_layer, in,
ln1, ln2, in1, out, out1}}`` (CoDMR) and ``{"rec": {user_embedding,
item_id_embedding, image_residual: [{lin, bn}], image_modal, text_residual,
text_modal, gate_image, gate_text, common1, common2: {w}}, "denoise_image":
{emb, down: [...], up: [...]}, "denoise_text", "feat_denoise_image":
{img_enc1, img_bn1, ..., att_o}, "feat_denoise_text"}`` (MVDiff).
The Rectified-Flow models keep their host's tree beside ``{rf:
{time_lin, cond_lin, cond_ln: {g, b}, in_lin, in_ln, res_blocks: [{l1,
ln1, l2, ln2}], out_lin1, out_ln, out_lin2}}`` (the 15 RF hosts,
GenRecBM3, RFGUME, RFGUMETime) and ``{causal_denoiser: {alpha, beta,
denoise_W: [{w, b}]}}`` (GenRecBM3, RFGUME with ``use_denoise``; ``alpha``
and ``beta`` 0-d leaves). RFMRec keeps ``{user_embedding, item_embedding,
visual_proj, text_proj, velocity: {time1, time2, time3, enc_interaction:
{layers: [{lin, ln}], skip}, enc_visual, enc_text, in_lin, in_ln,
out_lin1, out_ln, out_lin2, skip_scale, cross: [{attn: {wq, wk, wv, bq,
bk, bv, wo, bo}, ln1, ln2, ffn1, ffn2}], selfa: [{attn, ln}], res: [{net1,
net2, gn: {g, b}, scale1, scale2, shift1, shift2, ln}], mid: [{lin,
ln}]}}``: the attention's projections are bare leaves, as are
``skip_scale``, ``alpha`` and ``beta``.

``from_jax_state`` carries a model's JAX ``state`` across (DiffRec's and
LD4MRec's loss histories, MCDRec's ``graph_vals``, MVDiff's graphs; a 0-d
integer, the RF models' ``rf_epoch`` or ``epoch``, as a Python int).

``jax_tree_by_name`` and ``params_by_jax_name`` flatten the two sides into
one naming, ``"rec/uEmbeds"``, ``"denoise_image/in_layers/0/w"``, so that
parameters can be compared leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from genmmrec_tpu_torch.parallel import mesh as pm

_LEAF_NAMES = {"w": "weight", "b": "bias"}
_JAX_LEAF_NAMES = {v: k for k, v in _LEAF_NAMES.items()}
# top-level subtrees of a JAX tree that has them; every other parameter of
# such a model sits under "rec"
_TOP_LEVEL = ("denoise_image", "denoise_text", "feat_denoise_image", "feat_denoise_text")


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
    differ. A parameter held as this rank's rows (``held_rows``) takes its
    rows of the whole leaf."""
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
        if tuple(leaf.shape) != pm.whole_shape(p):
            raise ValueError(f"{name}: shape {tuple(leaf.shape)} != {pm.whole_shape(p)}")
        pm.copy_rows_(p, torch.tensor(leaf, dtype=p.dtype))
    return model


def from_jax_state(model: nn.Module, state) -> dict:
    """The port's ``state`` from a JAX model state of numpy leaves: each
    array a tensor on the model's device (integers as int64); a dict of
    ``rows``/``cols``/``vals`` edges becomes the model's graph of that
    entry (``model.state_graph_from_edges(name, edges)``)."""

    def conv(name, value):
        if isinstance(value, dict):
            edges = {k: conv(k, v) for k, v in value.items()}
            return model.state_graph_from_edges(name, edges) if set(edges) == {"rows", "cols", "vals"} else edges
        a = np.asarray(value)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        t = torch.as_tensor(np.array(a, dtype=np.int64 if np.issubdtype(a.dtype, np.integer) else a.dtype))
        return t.to(model.device)

    return {k: conv(k, v) for k, v in state.items()}


def jax_tree_by_name(tree) -> dict:
    """``{"rec/uEmbeds": array, ...}`` from a JAX parameter pytree."""
    out = {}
    for path, leaf in _flatten(tree):
        parts = list(path[:-1]) + [_JAX_LEAF_NAMES.get(path[-1], path[-1])]
        out["/".join(parts)] = np.asarray(leaf)
    return out


def params_by_jax_name(model: nn.Module) -> dict:
    """The model's parameters as numpy arrays under the JAX tree's names (a
    parameter held as this rank's rows: those rows)."""
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
