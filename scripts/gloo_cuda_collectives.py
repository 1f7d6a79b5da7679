#!/usr/bin/env python3
"""Which collectives the gloo backend runs on CUDA tensors, and how long the
mesh layer's collectives take, with ranks that share one GPU.

    python3 scripts/gloo_cuda_collectives.py [--ranks 4]

Starts the ranks with ``genmmrec_tpu_torch.parallel.launch.run`` (gloo: the
ranks share one card), tries each collective of ``torch.distributed`` on a
CUDA tensor and reports whether it ran and gave the right values, then
times, with CUDA tensors, the all-gather of a (4,096, 50) top-k (values and
ids) over two ranks and over all of them, and an all-reduce over all of
them of 2,145,152 float32 values (about DiffMM/baby's main parameters:
19,445 + 7,050 rows of 64 and the two feature transforms), as
``parallel.mesh`` runs them. Prints one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIFFMM_BABY_REC = (19445 + 7050) * 64 + 4096 * 64 + 384 * 64 + 2


def _try(fn):
    try:
        return "ok" if fn() else "wrong values"
    except (RuntimeError, ValueError) as e:  # a collective gloo refuses on CUDA tensors
        return f"refused: {str(e).splitlines()[0][:160]}"


def _probe(device, reps):
    import torch
    import torch.distributed as dist

    from genmmrec_tpu_torch.parallel import mesh as pm

    rank, world = dist.get_rank(), dist.get_world_size()
    t = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    total = float(sum(range(1, world + 1)))

    def all_reduce():
        x = t(rank + 1.0)
        dist.all_reduce(x)
        return x.item() == total

    def broadcast():
        x = t(rank + 1.0)
        dist.broadcast(x, 0)
        return x.item() == 1.0

    def all_gather():
        parts = [t(0.0) for _ in range(world)]
        dist.all_gather(parts, t(rank + 1.0))
        return [p.item() for p in parts] == [r + 1.0 for r in range(world)]

    def all_gather_into_tensor():
        out = torch.empty(world, device=device)
        dist.all_gather_into_tensor(out, t(rank + 1.0))
        return out.tolist() == [r + 1.0 for r in range(world)]

    def reduce_scatter_tensor():
        out = torch.empty(1, device=device)
        dist.reduce_scatter_tensor(out, torch.ones(world, device=device))
        return out.item() == float(world)

    def reduce():
        x = t(rank + 1.0)
        dist.reduce(x, 0)
        return rank != 0 or x.item() == total

    def barrier():
        dist.barrier()
        return True

    support = {fn.__name__: _try(fn) for fn in (
        all_reduce, broadcast, all_gather, all_gather_into_tensor, reduce_scatter_tensor, reduce, barrier)}
    dist.barrier()

    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None

    def timed(fn):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    times = {}
    vals = torch.randn(4096, 50, device=device)
    idx = torch.randint(0, 7050, (4096, 50), device=device)
    for m in sorted({2, world}):
        mesh = pm.build_mesh({"mesh_shape": {"data": world // m, "model": m}})
        gather = lambda: (pm.all_gather(vals[None], mesh, pm.MODEL_AXIS), pm.all_gather(idx[None], mesh, pm.MODEL_AXIS))
        times[f"all_gather_topk_4096x50_model{m}_ms"] = timed(gather)
    mesh = pm.build_mesh({"mesh_shape": {"data": world, "model": 1}})
    grads = torch.randn(DIFFMM_BABY_REC, device=device)
    times[f"all_reduce_diffmm_baby_grads_data{world}_ms"] = timed(lambda: pm.all_reduce(grads, mesh, pm.DATA_AXIS))
    return {"support": support, "times": times}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_collectives: no CUDA device", file=sys.stderr)
        return 1
    from genmmrec_tpu_torch.parallel import launch

    out = launch.run(_probe, {"data": args.ranks}, "cuda", (args.reps,))
    if torch.cuda.device_count() < args.ranks:
        out["backend"] = "gloo"
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
