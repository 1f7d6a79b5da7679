"""Multimodal interest clustering and interest-debiased generation
(counterpart of ``genmmrec_tpu/common/interest_cluster.py``).

- Device k-means (``kmeans_single``, ``kmeans_fit``): k-means++ D² seeding,
  then Lloyd iterations in full float32 until the centers move less than
  ``tol`` or ``max_iter`` is reached, the best inertia over ``n_init``
  seeded restarts. An iteration reads one scalar back, its shift.
- ``MultimodalCluster``: per-modality k-means over features standardized
  in float64, with the per-dataset cluster counts ``OPTIMAL_K`` or the
  reference's auto-k rule (argmin of the inertia curve's second
  difference); and the spectral clustering of fused features
  (``multimodal_fusion_cluster``): the cosine similarity, each row's top
  ``sim_top_k`` (K3 on the card), ``max(S, Sᵀ)``, sklearn's spectral
  embedding of that affinity (``spectral_embedding``) and the k-means
  above on it.
- ``build_debias_tables`` and ``interest_debias``: of the entries the
  generator flipped, a ``sample_ratio`` share is examined again. A 0→1 flip
  stays only if the item's image or text cluster is among the user's train
  clusters; a 1→0 flip is accepted only when the user's count of the item's
  text cluster is at most the user's rarest cluster count + 1.

The per-user tables go to the items by gathers at the items' labels, which
give exactly the JAX package's indicator products (each item sits in one
cluster, so its column of the indicator matrix holds a single 1).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk

# per-dataset optimal cluster counts (reference trainer.py:632-648)
OPTIMAL_K = {
    "tiktok": {"image": 18, "text": 59, "audio": 46},
    "baby": {"image": 6, "text": 11},
    "sports": {"image": 9, "text": 12},
}
DEFAULT_K = {"image": 18, "text": 59, "audio": 46}


def _dist2(x, x_sq, centers):
    cross = x @ centers.T
    return (x_sq[:, None] - 2.0 * cross + (centers * centers).sum(-1)[None, :]).clamp(min=0.0)


def kmeans_pp_seeds(x: torch.Tensor, k: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """k-means++ D² seeding, as ``jax.random.choice(n, p=D²/ΣD²)`` draws:
    the first center uniform, each next one where the cumulative D² first
    reaches ``ΣD² · (1 − u)``. When every distance is 0 (k above the number
    of distinct points) that is row 0, as in the JAX package. No host read."""
    n, dev = x.shape[0], x.device
    first = torch.randint(0, n, (1,), generator=generator, device=dev)
    centers = torch.zeros(k, x.shape[1], dtype=x.dtype, device=dev)
    centers[0] = x[first[0]]
    mind = ((x - x[first]) ** 2).sum(-1)
    for i in range(1, k):
        cum = torch.cumsum(mind / mind.sum().clamp(min=1e-12), 0)
        r = cum[-1:] * (1.0 - torch.rand(1, generator=generator, device=dev))
        c = x[torch.searchsorted(cum, r).clamp(max=n - 1)]
        centers[i] = c[0]
        mind = torch.minimum(mind, ((x - c) ** 2).sum(-1))
    return centers


def kmeans_single(
    x: torch.Tensor,
    k: int,
    generator: Optional[torch.Generator] = None,
    max_iter: int = 100,
    tol: float = 1e-4,
    centers: Optional[torch.Tensor] = None,
):
    """One k-means run on float32 rows ``x`` → (labels (n,), inertia 0-d
    tensor). ``centers`` gives the initial centers in place of the k-means++
    seeding. An empty cluster keeps its center; ties go to the lower
    cluster."""
    full_precision_matmuls()
    n = x.shape[0]
    x_sq = (x * x).sum(-1)
    if centers is None:
        centers = kmeans_pp_seeds(x, k, generator)
    ones = torch.ones(n, dtype=x.dtype, device=x.device)
    for _ in range(max_iter):
        labels = torch.argmin(_dist2(x, x_sq, centers), dim=1)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(0, labels, ones)
        sums = torch.zeros_like(centers).index_add_(0, labels, x)
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], centers)
        shift = ((new - centers) ** 2).sum()
        centers = new
        if not float(shift) > tol:
            break
    d = _dist2(x, x_sq, centers)
    labels = torch.argmin(d, dim=1)
    return labels, d.gather(1, labels[:, None]).sum()


def kmeans_fit(features: torch.Tensor, k: int, n_init: int = 10, seed: int = 0, max_iter: int = 100):
    """Best-of-``n_init`` k-means on ``features``' device → (labels, inertia
    as a float). Restart ``i`` draws from a generator seeded with
    ``seed · 1000003 + i``."""
    x = features.to(torch.float32)
    best_labels, best_inertia = None, float("inf")
    for i in range(n_init):
        gen = torch.Generator(device=x.device).manual_seed(seed * 1000003 + i)
        labels, inertia = kmeans_single(x, int(k), gen, max_iter=max_iter)
        inertia = float(inertia)
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels, best_inertia


def spectral_embedding(affinity: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) embedding of a symmetric affinity, as sklearn's
    ``SpectralClustering(affinity="precomputed")`` computes it (scipy's
    normalized Laplacian of the affinity without its diagonal, the
    diagonal set to 1, the eigenvectors of the ``k`` smallest eigenvalues,
    each divided by the square root of the degrees and signed so that its
    largest magnitude is positive), in float64 by ``torch.linalg.eigh``."""
    a = affinity.to(torch.float64).clone()
    a.fill_diagonal_(0.0)
    deg = a.sum(0)
    dd = torch.where(deg == 0, 1.0, deg.sqrt())
    lap = -(a / dd) / dd[:, None]
    lap.fill_diagonal_(1.0)
    vecs = torch.linalg.eigh(lap).eigenvectors[:, :k].T / dd
    pick = vecs.abs().argmax(1)
    signs = torch.sign(vecs.gather(1, pick[:, None]))
    return (vecs * signs).T


class MultimodalCluster:
    def __init__(
        self,
        use_auto_optimal_k: bool = False,
        kmeans_cluster_num_min: int = 3,
        kmeans_cluster_num_max: int = 237,
        kmeans_stride: int = 10,
        seed: int = 0,
        spectral_cluster_num: int = 20,
        sim_top_k: int = 20,
    ):
        self.spectral_cluster_num = spectral_cluster_num
        self.sim_top_k = sim_top_k
        self.use_auto_optimal_k = use_auto_optimal_k
        self.k_min = kmeans_cluster_num_min
        self.k_max = kmeans_cluster_num_max
        self.stride = kmeans_stride
        self.seed = seed

    @staticmethod
    def standardize(features: torch.Tensor) -> torch.Tensor:
        """Per-column (x − mean) / max(std, 1e-12), computed in float64 and
        stored in float32."""
        f = features.to(torch.float64)
        sd = f.std(dim=0, keepdim=True, correction=0)
        return ((f - f.mean(dim=0, keepdim=True)) / sd.clamp(min=1e-12)).to(torch.float32)

    def multimodal_specific_cluster(self, features: torch.Tensor, optimal_cluster_num: int) -> torch.Tensor:
        """Cluster labels of the items' standardized ``features``, with
        ``optimal_cluster_num`` clusters or the auto-k rule's, clamped to
        [2, n]."""
        feats = self.standardize(features)
        k = self.get_kmeans_cluster_optimal_num(feats) if self.use_auto_optimal_k else optimal_cluster_num
        k = max(2, min(int(k), feats.shape[0]))
        labels, _ = kmeans_fit(feats, k, n_init=10, seed=self.seed)
        return labels

    def get_kmeans_cluster_optimal_num(self, feats: torch.Tensor) -> int:
        """The reference's auto-k rule: over k = k_min, k_min + stride, …
        (below k_max and n), the argmin of the inertia curve's second
        difference, + k_min + 1."""
        distortions = [
            kmeans_fit(feats, i, n_init=10, seed=self.seed)[1]
            for i in range(self.k_min, min(self.k_max, feats.shape[0]), self.stride)
        ]
        return int(np.argmin(np.diff(np.diff(distortions)))) + self.k_min + 1

    def fusion_affinity(self, fusion_feats: torch.Tensor) -> torch.Tensor:
        """(n, n) float64: the cosine similarity of the fused features with
        each row's top ``sim_top_k`` kept (K3 on the float32 similarity on
        the card) and the rest 0, then ``max(S, Sᵀ)``."""
        full_precision_matmuls()
        f = fusion_feats.to(torch.float64)
        fn = f / torch.linalg.vector_norm(f, dim=1, keepdim=True).clamp(min=1e-12)
        sim = fn @ fn.T
        _, idx = grouped_topk(sim.to(torch.float32), min(self.sim_top_k, sim.shape[1]))
        kept = torch.zeros_like(sim).scatter_(1, idx, sim.gather(1, idx))
        return torch.maximum(kept, kept.T)

    def multimodal_fusion_cluster(self, fusion_feats: torch.Tensor) -> torch.Tensor:
        """Spectral cluster labels of the fused features, ``min(
        spectral_cluster_num, n − 1)`` clusters: ``fusion_affinity``, its
        ``spectral_embedding``, then ``kmeans_fit`` (10 restarts)."""
        sim = self.fusion_affinity(fusion_feats)
        k = min(self.spectral_cluster_num, sim.shape[0] - 1)
        labels, _ = kmeans_fit(spectral_embedding(sim, k), k, n_init=10, seed=self.seed)
        return labels


def build_debias_tables(
    train_users: torch.Tensor,
    train_items: torch.Tensor,
    n_users: int,
    image_labels: torch.Tensor,
    text_labels: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Per-user cluster tables on the labels' device: ``img_member`` (U, Ki)
    and ``txt_member`` (U, Kt) bool, ``txt_counts`` (U, Kt) float32, the
    smallest non-zero count ``txt_minfreq`` (U,) (0 for a user with none),
    and the item labels ``img_labels``, ``txt_labels`` (I,)."""
    dev = image_labels.device
    users = train_users.to(dev).long()
    items = train_items.to(dev).long()
    img, txt = image_labels.long(), text_labels.long()
    Ki, Kt = int(img.max()) + 1, int(txt.max()) + 1
    img_member = torch.zeros(n_users, Ki, dtype=torch.bool, device=dev)
    img_member[users, img[items]] = True
    txt_member = torch.zeros(n_users, Kt, dtype=torch.bool, device=dev)
    txt_member[users, txt[items]] = True
    txt_counts = torch.zeros(n_users, Kt, dtype=torch.float32, device=dev)
    txt_counts.index_put_((users, txt[items]), torch.ones_like(users, dtype=torch.float32), accumulate=True)
    minfreq = torch.where(txt_counts > 0, txt_counts, float("inf")).min(dim=1).values
    minfreq = torch.where(torch.isfinite(minfreq), minfreq, 0.0)
    return {
        "img_member": img_member,
        "txt_member": txt_member,
        "txt_counts": txt_counts,
        "txt_minfreq": minfreq,
        "img_labels": img,
        "txt_labels": txt,
    }


def interest_debias(
    users: torch.Tensor,
    origin: torch.Tensor,
    generated: torch.Tensor,
    tables: Dict[str, torch.Tensor],
    sample_ratio: float,
    generator: Optional[torch.Generator] = None,
    sampled: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The debiased (B, I) generated matrix of the batch's ``users``.
    ``sampled`` (B, I) bool marks the entries examined, drawn as
    ``uniform < sample_ratio`` from ``generator`` unless given."""
    flip01 = generated > origin
    flip10 = origin > generated
    if sampled is None:
        sampled = torch.rand(origin.shape, generator=generator, device=origin.device) < sample_ratio
    img_ok = tables["img_member"][users][:, tables["img_labels"]]
    txt_ok = tables["txt_member"][users][:, tables["txt_labels"]]
    keep01 = (img_ok | txt_ok).to(generated.dtype)
    freq = tables["txt_counts"][users][:, tables["txt_labels"]]
    minf = tables["txt_minfreq"][users][:, None]
    # a removal is accepted (the entry stays 0) when the cluster was rarely interacted
    keep10 = torch.where(freq <= minf + 1.0, 0.0, 1.0).to(generated.dtype)
    out = torch.where(flip01 & sampled, keep01, generated)
    return torch.where(flip10 & sampled, keep10, out)
