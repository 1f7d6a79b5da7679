"""Pre-extracted multimodal item features (image / text).

Counterpart of ``genmmrec_tpu/data/features.py``: ``image_feat.npy`` /
``text_feat.npy`` are loaded once; when both are absent and
``synthetic_fallback`` is set, the same deterministic synthetic features
as the JAX package's are generated. Returns host numpy arrays; the model
moves them to its device.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional, Tuple

import numpy as np


def load_modal_features(config, n_items: int) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Return (v_feat, t_feat) as float32 numpy arrays, loaded or synthesized."""
    if config["end2end"] or not config["is_multimodal_model"]:
        return None, None
    dataset_path = os.path.abspath(
        os.path.join(config["data_path"] or "./data/", config["dataset"] or "")
    )
    v_feat = t_feat = None
    v_path = os.path.join(dataset_path, config["vision_feature_file"] or "_")
    t_path = os.path.join(dataset_path, config["text_feature_file"] or "_")
    if os.path.isfile(v_path):
        v_feat = np.load(v_path).astype(np.float32)
    if os.path.isfile(t_path):
        t_feat = np.load(t_path).astype(np.float32)

    if v_feat is None and t_feat is None:
        if not config["synthetic_fallback"]:
            raise ValueError("Features all NONE")
        name_hash = zlib.crc32(str(config["dataset"]).encode())
        rng = np.random.default_rng(0xFEA7 ^ name_hash % (2**31))
        v_dim = int(config["synthetic_v_feat_dim"] or 4096)
        t_dim = int(config["synthetic_t_feat_dim"] or 384)
        v_feat = np.abs(rng.normal(0.0, 0.3, (n_items, v_dim))).astype(np.float32)
        t_feat = rng.normal(0.0, 0.5, (n_items, t_dim)).astype(np.float32)
    return v_feat, t_feat
