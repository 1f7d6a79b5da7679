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


def xavier_normal(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """N(0, 2/(fan_in+fan_out)) with fan_out, fan_in = shape[0], shape[-1]."""
    fan_out, fan_in = shape[0], shape[-1]
    return normal(shape, math.sqrt(2.0 / (fan_in + fan_out)), generator, dtype)


def uniform(shape, bound: float, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """U(±bound)."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-bound, bound, generator=generator)


def kaiming_uniform_default(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """``nn.Linear``'s default weight init, kaiming_uniform_(a=sqrt(5)):
    U(±1/sqrt(fan_in)) with fan_in = shape[-1]."""
    return uniform(shape, 1.0 / math.sqrt(shape[-1]), generator, dtype)


@torch.no_grad()
def init_linear(layer: torch.nn.Linear, generator: torch.Generator, init=xavier_normal, zero_bias: bool = False) -> None:
    """The JAX package's ``linear_params`` on an ``nn.Linear`` (weight
    (out, in), applied as x @ Wᵀ + b): ``init`` for the weight and
    U(±1/sqrt(fan_in)), ``nn.Linear``'s own default, for the bias, or zeros
    with ``zero_bias`` (the reference's VBPR zeroes its layer's bias)."""
    layer.weight.copy_(init(layer.weight.shape, generator))
    if layer.bias is not None and zero_bias:
        layer.bias.zero_()
    elif layer.bias is not None:
        layer.bias.copy_(uniform(layer.bias.shape, 1.0 / math.sqrt(layer.in_features), generator))
