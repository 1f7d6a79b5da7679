#!/usr/bin/env python3
"""Loss landscape around a checkpoint of the PyTorch/CUDA port (counterpart
of ``scripts/visualize_landscape.py``): the training loss over a 2-D plane
through the checkpointed parameters, spanned by two random directions, each
leaf scaled to its parameter's norm (Li et al., "Visualizing the Loss
Landscape of Neural Nets").

- Only the model's parameters move (``named_parameters``, the names
  ``interop.params_by_jax_name`` gives); buffers and the model ``state``
  (regenerated graphs, epoch counters) stay as the checkpoint holds them.
- The loss at every point draws from a generator seeded the same, so the
  surface is a function of (α, β) alone, as the JAX tool's one ``k_loss``
  makes it. The directions, the batch's negatives and the loss take
  generators seeded 1, 2, 3 and 4.
- The grid runs point by point under ``torch.no_grad()`` on the device
  (the model's propagations through K1 or K2 on the card); the parameters
  are copied back from a saved copy afterwards, bit for bit.

It prints ``loss at checkpoint = …`` (the grid's centre), writes the grid
and the coordinates to ``landscape_<model>_<dataset>.npz`` (``--out``
names the ``.npz``; a ``.png`` beside it where ``matplotlib`` imports),
and ends with one JSON line (added to ``--journal`` too): the grid's
seconds, the kernels' launches in the grid and, with ``--against-plain``,
the largest difference from the same grid through the kernels' plain
versions on the same device.

Usage:
    python scripts/visualize_landscape_torch.py --model LightGCN --dataset baby \\
        --checkpoint saved/LightGCN-baby --steps 40 --distance 10 [--device cpu] \\
        [--config-json '{"use_rf": false}'] [--against-plain]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402


@torch.no_grad()
def filter_normalize(directions: dict, params: dict) -> dict:
    """Per leaf: the random direction scaled to its parameter's norm,
    ``d · ‖p‖ / max(‖d‖, 1e-10)``."""
    out = {}
    for k, d in directions.items():
        dn = torch.linalg.vector_norm(d.reshape(-1))
        pn = torch.linalg.vector_norm(params[k].reshape(-1))
        out[k] = d * (pn / torch.clamp(dn, min=1e-10))
    return out


def random_directions(model, seed: int) -> dict:
    """One normal tensor the shape of each parameter, from a generator on
    the model's device seeded ``seed``, in ``named_parameters`` order."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) for k, p in params.items()}


@torch.no_grad()
def loss_grid(model, state, batch, d1: dict, d2: dict, coords, seed: int) -> np.ndarray:
    """(len(coords), len(coords)) losses: entry (i, j) is
    ``model.loss(state, batch, gen)`` at parameters ``w + coords[i]·d1 +
    coords[j]·d2``, ``gen`` seeded ``seed`` at every point. The parameters
    are restored from a copy before the function returns."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    saved = {k: p.detach().clone() for k, p in params.items()}
    cs = torch.as_tensor(np.asarray(coords, dtype=np.float32), device=dev)
    grid = torch.empty(len(cs), len(cs), device=dev)
    try:
        for i in range(len(cs)):
            for j in range(len(cs)):
                for k, p in params.items():
                    p.copy_(saved[k] + cs[i] * d1[k] + cs[j] * d2[k])
                total, _ = model.loss(state, batch, torch.Generator(device=dev).manual_seed(seed))
                grid[i, j] = total
    finally:
        for k, p in params.items():
            p.copy_(saved[k])
    return grid.cpu().numpy()


def landscape_batch(td, batch_size: int, seed: int) -> dict:
    """The first ``batch_size`` train interactions, one negative each (the
    port's sampler, seeded ``seed``), unit weights."""
    from genmmrec_tpu_torch.data.arrays import sample_negatives

    B = min(batch_size, td.n_inter)
    users = td.users[:B]
    gen = torch.Generator(device=users.device).manual_seed(seed)
    return {
        "users": users,
        "pos": td.items[:B],
        "neg": sample_negatives(users, td.hist, td.item_pool, td.n_pool, generator=gen),
        "weight": torch.ones(B, device=users.device),
    }


@contextlib.contextmanager
def plain_versions():
    """K1 and K2, forward and backward, replaced by their plain PyTorch
    versions for the duration (the same sums on any device; their launch
    counts stay 0)."""
    from genmmrec_tpu_torch.ops import segment as S

    saved = {n: getattr(S, n) for n in ("segment_spmm", "segment_spmm_backward", "segment_spmm_blocked",
                                        "segment_spmm_blocked_backward")}

    def csr(row_ptr, cols, vals, x, n_rows, long_rows=None):
        return S.segment_spmm_plain(row_ptr, cols, vals, x.contiguous(), n_rows)

    def blocked(row_ptr, rows, cols, vals, x, n_rows):
        return S.segment_spmm_blocked_plain(rows, cols, vals, x.contiguous(), n_rows)

    csr.launches = blocked.launches = 0
    S.segment_spmm = S.segment_spmm_backward = csr
    S.segment_spmm_blocked = S.segment_spmm_blocked_backward = blocked
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(S, n, f)


def load_model(model_name: str, dataset: str, checkpoint: str, device, overrides=None):
    """(model, state, train data) of ``checkpoint`` (``<path>`` or
    ``<path>.pt``, as the trainer writes it), the model built on
    ``dataset``'s train split from the merged config and ``overrides``."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.checkpoint import load_checkpoint
    from genmmrec_tpu_torch.models import get_model

    config = Config(model_name, dataset, {"save_recommended_topk": False, **(overrides or {})})
    train_ds, _, _ = RecDataset(config).split()
    td = build_train_data(train_ds, device)
    model = get_model(model_name)(config, td)
    ck = load_checkpoint(checkpoint[:-3] if checkpoint.endswith(".pt") else checkpoint, map_location=device)
    model.load_state_dict(ck["params"])
    state = ck.get("state") or model.init_state(torch.Generator(device=device).manual_seed(0))
    return model, state, td


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--distance", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="the .npz (default landscape_<model>_<dataset>.npz)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config-json", default=None, help="config overrides the run was trained with (inline JSON)")
    ap.add_argument("--journal", default=None, help="a JSON journal to add the report to, as landscape/<model>/<dataset>")
    ap.add_argument("--against-plain", action="store_true",
                    help="compute the grid again through the kernels' plain versions, report the difference, "
                         "and fail if a kernel launches there")
    args = ap.parse_args(argv)

    from genmmrec_tpu_torch.ops import launch_counts
    from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
    from genmmrec_tpu_torch.quick_start import resolve_device

    device = resolve_device(args.device)
    full_precision_matmuls()
    overrides = json.loads(args.config_json) if args.config_json else None
    model, state, td = load_model(args.model, args.dataset, args.checkpoint, device, overrides)
    params = dict(model.named_parameters())
    d1 = filter_normalize(random_directions(model, 1), params)
    d2 = filter_normalize(random_directions(model, 2), params)
    batch = landscape_batch(td, args.batch_size, 3)
    coords = np.linspace(-args.distance / 2, args.distance / 2, args.steps, dtype=np.float32)

    def timed():
        if device.type == "cuda":
            torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        grid = loss_grid(model, state, batch, d1, d2, coords, 4)
        seconds = time.perf_counter() - t0
        after = launch_counts()
        return grid, seconds, {k: after[k] - before[k] for k in after}

    grid, seconds, launches = timed()
    report = dict(model=args.model, dataset=args.dataset, steps=args.steps, distance=args.distance,
                  device=str(device), grid_s=seconds, launches=launches,
                  loss_at_checkpoint=float(grid[args.steps // 2, args.steps // 2]),
                  finite=bool(np.isfinite(grid).all()))
    if args.against_plain:
        with plain_versions():
            plain, plain_s, plain_launches = timed()
        report.update(plain_grid_s=plain_s, plain_launches=plain_launches,
                      max_abs_diff_to_plain=float(np.abs(grid - plain).max()))

    out = args.out or f"landscape_{args.model}_{args.dataset}.npz"
    np.savez(out, grid=grid, coords=coords)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None
    if plt is not None:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
        X, Y = np.meshgrid(coords, coords)
        cs = ax1.contourf(X, Y, grid, levels=30, cmap="viridis")
        fig.colorbar(cs, ax=ax1)
        ax1.set_title(f"{args.model}/{args.dataset} loss contours")
        ax2.plot(coords, grid[args.steps // 2])
        ax2.set_title("1-D slice through the checkpoint")
        ax2.set_xlabel("α")
        ax2.set_ylabel("loss")
        png = os.path.splitext(out)[0] + ".png"
        plt.savefig(png, dpi=150, bbox_inches="tight")
        plt.close(fig)
        out += f" and {png}"
    print(f"Saved {out}; loss at checkpoint = {grid[args.steps // 2, args.steps // 2]:.4f}")
    print(json.dumps(report), flush=True)
    if args.journal:
        import harness_torch

        report["card"] = harness_torch.card_line(str(device))
        harness_torch.record(args.journal, f"landscape/{args.model}/{args.dataset}", report)
    if args.against_plain and any(report["plain_launches"].values()):
        print(f"a kernel launched on the plain grid: {report['plain_launches']}", file=sys.stderr)
        return 1
    return 0 if report["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
