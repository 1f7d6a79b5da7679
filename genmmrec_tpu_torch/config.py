"""Three-tier YAML configuration with the hyper-parameter grid.

Counterpart of ``genmmrec_tpu/config.py``. The tier files live in the
port's own ``configs/`` tree, a copy of the JAX package's
(``tests/test_torch_cli.py`` holds the two byte-equal).

- merge order: ``overall.yaml`` < ``dataset/<ds>.yaml`` < ``model/<m>.yaml``
  (< ``mg.yaml`` when ``mg=True``), then the runtime ``config_dict`` wins;
- ``hyper_parameters`` lists from every file are concatenated (and ``seed``
  is always appended);
- an implicit YAML float resolver so ``1e-5``-style scalars parse as floats;
- ``valid_metric_bigger`` derived from ``valid_metric``.
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Any, Dict, List, Optional

import yaml

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

_FLOAT_RE = re.compile(
    r"""^(?:
     [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)


class _Loader(yaml.SafeLoader):
    """Safe loader with the float resolver of the JAX package's config."""


_Loader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT_RE, list("-+0123456789."))


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        data = yaml.load(f.read(), Loader=_Loader)
    return data or {}


class Config:
    """Dict-like merged configuration; ``config[key]`` is ``None`` when absent."""

    SMALLER_METRICS = ("rmse", "mae", "logloss")

    def __init__(
        self,
        model: Optional[str] = None,
        dataset: Optional[str] = None,
        config_dict: Optional[Dict[str, Any]] = None,
        mg: bool = False,
        config_root: Optional[str] = None,
    ):
        config_dict = dict(config_dict or {})
        config_dict["model"] = model
        config_dict["dataset"] = dataset
        self.config_root = config_root or CONFIG_ROOT

        merged: Dict[str, Any] = {}
        hyper: List[str] = []
        files = [
            os.path.join(self.config_root, "overall.yaml"),
            os.path.join(self.config_root, "dataset", f"{dataset}.yaml"),
            os.path.join(self.config_root, "model", f"{model}.yaml"),
        ]
        if mg:
            files.append(os.path.join(self.config_root, "mg.yaml"))
        for path in files:
            if os.path.isfile(path):
                data = load_yaml(path)
                if data.get("hyper_parameters"):
                    hyper.extend(data["hyper_parameters"])
                merged.update(data)
        merged["hyper_parameters"] = hyper
        merged.update(config_dict)
        self.final_config_dict = merged
        self._set_defaults()

    def _set_defaults(self) -> None:
        d = self.final_config_dict
        valid_metric = str(d.get("valid_metric", "Recall@20")).split("@")[0]
        d["valid_metric_bigger"] = valid_metric.lower() not in self.SMALLER_METRICS
        if "seed" not in d["hyper_parameters"]:
            d["hyper_parameters"] = list(d["hyper_parameters"]) + ["seed"]

    def __setitem__(self, key: str, value: Any) -> None:
        if not isinstance(key, str):
            raise TypeError("index must be a str.")
        self.final_config_dict[key] = value

    def __getitem__(self, item: str) -> Any:
        return self.final_config_dict.get(item)

    def __contains__(self, key: str) -> bool:
        if not isinstance(key, str):
            raise TypeError("index must be a str.")
        return key in self.final_config_dict

    def get(self, key: str, default: Any = None) -> Any:
        v = self.final_config_dict.get(key, default)
        return default if v is None else v

    def __str__(self) -> str:
        return "\n" + "\n".join(f"{k}={v}" for k, v in self.final_config_dict.items()) + "\n\n"

    __repr__ = __str__

    def hyper_grid(self):
        """Yield (names, combo) over the hyper-parameter product: a value
        named in ``hyper_parameters`` that is a list is an axis, any other
        value a singleton axis; names are de-duplicated in order."""
        names = list(dict.fromkeys(self.final_config_dict["hyper_parameters"]))
        axes = []
        for name in names:
            v = self.final_config_dict.get(name)
            axes.append(v if isinstance(v, list) else [v])
        for combo in itertools.product(*axes):
            yield names, combo
