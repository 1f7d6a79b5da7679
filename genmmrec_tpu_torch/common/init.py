"""Parameter initializers (counterpart of ``genmmrec_tpu/common/init.py``).

Each draws from an explicit ``torch.Generator`` and returns a new tensor on
that generator's device. The draws differ from ``jax.random``'s for the
same seed; parity tests copy JAX parameters in by name instead
(``genmmrec_tpu_torch.interop``).
"""

from __future__ import annotations

import math

import torch


def xavier_uniform(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """U(±sqrt(6/(fan_in+fan_out))) with fan_out, fan_in = shape[0], shape[-1]."""
    fan_out, fan_in = shape[0], shape[-1]
    a = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-a, a, generator=generator)


def normal(shape, std: float, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.normal_(0.0, std, generator=generator)
