"""Offline preprocessing: raw ratings/meta → the framework's inputs.

Counterpart of ``genmmrec_tpu/preprocessing``, on numpy and the standard
library (no pandas), as a CLI:

    python -m genmmrec_tpu_torch.preprocessing rating2inter --ratings r.csv --out d/ --dataset x
    python -m genmmrec_tpu_torch.preprocessing split --inter d/x-indexed.inter --out d/x.inter
    python -m genmmrec_tpu_torch.preprocessing reindex-feat --meta meta.json.gz --mapping d/i_id_mapping.csv --out d/meta-x.csv
    python -m genmmrec_tpu_torch.preprocessing encode-feat --meta d/meta-x.csv --out d/text_feat.npy
    python -m genmmrec_tpu_torch.preprocessing uu-graph --inter d/x.inter --out d/user_graph_dict.npy [--device cpu]

The files follow the reference's contract: ``<ds>.inter`` TSV (userID,
itemID, rating, timestamp, x_label), ``text_feat.npy`` (n_items, dim) and
``user_graph_dict.npy`` (each user's top-200 co-occurring users). The
user graph's counts and top-k run on the card unless ``--device cpu``.
"""

from genmmrec_tpu_torch.preprocessing.pipeline import (
    build_user_graph_dict,
    encode_text_features,
    kcore_filter,
    per_user_split,
    rating2inter,
    reindex_meta,
    save_user_graph_dict,
    user_graph_dict,
)

__all__ = [
    "kcore_filter",
    "rating2inter",
    "per_user_split",
    "reindex_meta",
    "encode_text_features",
    "build_user_graph_dict",
    "save_user_graph_dict",
    "user_graph_dict",
]
