"""CLI of the preprocessing pipeline: one subcommand a reference notebook,
the JAX package's flags, and ``uu-graph --device`` (default ``cuda``)."""

from __future__ import annotations

import argparse
import logging

from genmmrec_tpu_torch.preprocessing.pipeline import (
    encode_text_features,
    per_user_split,
    rating2inter,
    reindex_meta,
    save_user_graph_dict,
)


def main(argv=None):
    p = argparse.ArgumentParser(prog="genmmrec_tpu_torch.preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("rating2inter", help="k-core filter + reindex + time split")
    s.add_argument("--ratings", required=True, help="raw ratings CSV (user,item,rating,ts)")
    s.add_argument("--out", required=True, help="output directory")
    s.add_argument("--dataset", required=True)
    s.add_argument("--min-u", type=int, default=5)
    s.add_argument("--min-i", type=int, default=5)

    s = sub.add_parser("split", help="per-user 80/10/10 re-split of an indexed .inter")
    s.add_argument("--inter", required=True)
    s.add_argument("--out", default=None)
    s.add_argument("--seed", type=int, default=999)

    s = sub.add_parser("reindex-feat", help="remap meta asin -> dense itemID")
    s.add_argument("--meta", required=True, help="meta .json.gz/.csv")
    s.add_argument("--mapping", required=True, help="i_id_mapping.csv")
    s.add_argument("--out", required=True, help="output meta CSV")

    s = sub.add_parser("encode-feat", help="item text -> text_feat.npy")
    s.add_argument("--meta", required=True, help="reindexed meta CSV")
    s.add_argument("--out", required=True, help="output .npy")
    s.add_argument("--model", default="sentence-transformers/all-MiniLM-L6-v2")

    s = sub.add_parser("uu-graph", help="DualGNN user co-occurrence graph")
    s.add_argument("--inter", required=True)
    s.add_argument("--out", required=True, help="user_graph_dict.npy path")
    s.add_argument("--top-k", type=int, default=200)
    s.add_argument("--device", default="cuda", help="device of the counts and the top-k (cuda or cpu)")

    args = p.parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.cmd == "rating2inter":
        out = rating2inter(args.ratings, args.out, args.dataset, args.min_u, args.min_i)
    elif args.cmd == "split":
        out = per_user_split(args.inter, args.out, args.seed)
    elif args.cmd == "reindex-feat":
        reindex_meta(args.meta, args.mapping, args.out)
        out = args.out
    elif args.cmd == "encode-feat":
        encode_text_features(args.meta, args.out, args.model)
        out = args.out
    else:
        out = save_user_graph_dict(args.inter, args.out, args.top_k, args.device)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
