#!/usr/bin/env python
"""Generate the STRUCTURED synthetic dataset for the PyTorch/CUDA port:
latent-factor interactions with feature-correlated modalities.

The counterpart of ``scripts/make_structured_dataset.py``: the same seeds
(``0x57A7``, ``0x5717``, ``0xF3A7``) and the same numpy draws, so
``baby.inter``, ``image_feat.npy`` and ``text_feat.npy`` are the same
bytes. The user graph (``user_graph_dict.npy``, DualGNN's co-occurrence
lists) comes from the port's preprocessing (``uu-graph``: the counts and
their top-k on ``--device``, the card by default).

  * user/item latent factors  U ~ N(0, 1/sqrt(k)), V ~ N(0, 1/sqrt(k))
  * item popularity bias      b_i = pop_scale * g_i, g ~ N(0,1)
  * interactions: per-user top-m_u of  U_u V^T + b + Gumbel(tau) noise,
    m_u ~ clipped Poisson
  * modal features: noisy linear maps of the item factors
      image = relu(V Wv + sv * eps)   (non-negative, like CNN embeddings)
      text  =      V Wt + st * eps    (signed, like sentence embeddings)
  * a per-user random 8:1:1 x_label split

The files carry the baby dataset's names, so a run reads them by
overriding ``data_path``:

    python scripts/make_structured_dataset_torch.py
    python -m genmmrec_tpu_torch -m VBPR -d baby \\
        --config-json '{"data_path": "<repo>/data_struct/"}'
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "data_struct", "baby"))
    ap.add_argument("--n-users", type=int, default=4000)
    ap.add_argument("--n-items", type=int, default=2000)
    ap.add_argument("--latent-k", type=int, default=24)
    ap.add_argument("--mean-degree", type=float, default=25.0)
    ap.add_argument("--pop-scale", type=float, default=0.25)
    ap.add_argument("--gumbel-tau", type=float, default=0.35)
    ap.add_argument("--feat-noise", type=float, default=1.0,
                    help="modal noise scale relative to signal std")
    ap.add_argument("--v-dim", type=int, default=4096)
    ap.add_argument("--t-dim", type=int, default=384)
    ap.add_argument("--uu-topk", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="device of the user graph's counts and top-k (cuda or cpu)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    inter_path = os.path.join(args.out, "baby.inter")
    if os.path.isfile(inter_path) and not args.force:
        print(f"{inter_path} already exists; use --force to overwrite")
        return
    os.makedirs(args.out, exist_ok=True)

    n_u, n_i, k = args.n_users, args.n_items, args.latent_k
    rng = np.random.default_rng(0x57A7)

    U = rng.normal(0.0, 1.0 / np.sqrt(k), (n_u, k))
    V = rng.normal(0.0, 1.0 / np.sqrt(k), (n_i, k))
    pop = args.pop_scale * rng.normal(0.0, 1.0, n_i)

    scores = U @ V.T + pop[None, :]
    scores += args.gumbel_tau * rng.gumbel(0.0, 1.0, scores.shape)

    degree = np.clip(rng.poisson(args.mean_degree, n_u), 5, 120)
    order = np.argsort(-scores, axis=1)

    users_l, items_l, labels_l = [], [], []
    split_rng = np.random.default_rng(0x5717)
    for u in range(n_u):
        m = int(degree[u])
        its = order[u, :m]
        # per-user random 8:1:1 split; >=3 train so valid/test users are warm
        perm = split_rng.permutation(m)
        n_test = max(1, m // 10)
        n_valid = max(1, m // 10)
        lab = np.zeros(m, dtype=np.int64)
        lab[perm[:n_test]] = 2
        lab[perm[n_test:n_test + n_valid]] = 1
        users_l.append(np.full(m, u, dtype=np.int64))
        items_l.append(its.astype(np.int64))
        labels_l.append(lab)

    users = np.concatenate(users_l)
    items = np.concatenate(items_l)
    labels = np.concatenate(labels_l)
    ratings = rng.choice([3.0, 4.0, 5.0], size=len(users), p=[0.15, 0.35, 0.5])
    times = np.arange(len(users), dtype=np.int64)

    with open(inter_path, "w") as f:
        f.write("userID\titemID\trating\ttimestamp\tx_label\n")
        for u, i, r, t, x in zip(users, items, ratings, times, labels):
            f.write(f"{u}\t{i}\t{r:.1f}\t{t}\t{x}\n")
    used_items = len(np.unique(items))
    print(f"wrote {inter_path}: {len(users)} rows, {n_u} users x {n_i} items "
          f"({used_items} with >=1 interaction), "
          f"sparsity {1 - len(users) / (n_u * n_i):.4%}")

    # modal features: noisy projections of the item factors. Signal std of
    # (V W)_ij is ~1/sqrt(k)*sqrt(k)=|V_i| ~ 1, noise std = feat_noise.
    frng = np.random.default_rng(0xF3A7)
    Wv = frng.normal(0.0, 1.0, (k, args.v_dim))
    Wt = frng.normal(0.0, 1.0, (k, args.t_dim))
    v_sig = V @ Wv
    t_sig = V @ Wt
    v_feat = np.maximum(
        0.0, v_sig + args.feat_noise * v_sig.std() * frng.normal(size=v_sig.shape)
    ).astype(np.float32)
    t_feat = (
        t_sig + args.feat_noise * t_sig.std() * frng.normal(size=t_sig.shape)
    ).astype(np.float32)
    np.save(os.path.join(args.out, "image_feat.npy"), v_feat)
    np.save(os.path.join(args.out, "text_feat.npy"), t_feat)
    print(f"wrote image_feat {v_feat.shape}, text_feat {t_feat.shape} "
          f"(noise scale {args.feat_noise})")

    from genmmrec_tpu_torch.preprocessing.pipeline import save_user_graph_dict

    uu_path = os.path.join(args.out, "user_graph_dict.npy")
    save_user_graph_dict(inter_path, uu_path, top_k=args.uu_topk, device=args.device)
    print(f"wrote {uu_path} (top {args.uu_topk} on {args.device})")
    return args.out


if __name__ == "__main__":
    main()
