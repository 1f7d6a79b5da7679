"""Model registry (counterpart of ``genmmrec_tpu/models/__init__.py``):
model classes are resolved by name from
``genmmrec_tpu_torch.models.<name.lower()>``."""

from __future__ import annotations

import importlib


def get_model(model_name: str):
    module = importlib.import_module(f"genmmrec_tpu_torch.models.{model_name.lower()}")
    return getattr(module, model_name)
