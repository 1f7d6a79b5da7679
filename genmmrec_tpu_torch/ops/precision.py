"""The float32 product precision every entry point of the port sets."""

from __future__ import annotations

import torch


def full_precision_matmuls() -> None:
    """Keep float32 products in full float32: TF32 would keep about three
    decimal digits, and the scores only feed a top-k whose order must match
    the float32 reference. Set explicitly for both cuBLAS and cuDNN. A
    bfloat16 product likewise keeps its sums in float32 to the end (no
    split reduction in bfloat16), so that a score is rounded once."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
