"""Config: YAML load + dot-path overrides + attribute access.

Port of ``vavae_tpu/utils/config.py``. PyYAML is imported only inside the
functions that parse YAML, so code that builds a ``Config`` from a dict, or
loads a ``.json`` config without overrides, runs where PyYAML is not
installed. Override values are always parsed as YAML, as in the JAX
package, so they need PyYAML.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Iterable, Mapping


class Config(dict):
    """A dict with attribute access and recursive wrapping.

    ``cfg.train.max_steps`` and ``cfg['train']['max_steps']`` both work;
    missing attribute access raises AttributeError so hasattr() works."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        merged = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = v

    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, Config):
            return v
        if isinstance(v, Mapping):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k: str, v: Any) -> None:
        super().__setitem__(k, self._wrap(v))

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def merged_with(self, other: Mapping[str, Any]) -> "Config":
        """Recursive right-biased merge (later keys win), returns a new Config."""
        out = copy.deepcopy(self)
        _merge_into(out, other)
        return out

    def override(self, dotlist: Iterable[str]) -> "Config":
        """Apply ``key.path=value`` overrides (values parsed as YAML)."""
        import yaml

        out = copy.deepcopy(self)
        for item in dotlist:
            key, _, raw = item.partition("=")
            node = out
            parts = key.strip().split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], Config):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = yaml.safe_load(raw)
        return out


def _merge_into(dst: Config, src: Mapping[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Config) and isinstance(v, Mapping):
            _merge_into(dst[k], v)
        else:
            dst[k] = v


def load_config(*paths: str, overrides: Iterable[str] = ()) -> Config:
    """Load one or more YAML (or ``.json``) files (left-to-right merge) +
    dotlist overrides."""
    cfg = Config()
    for p in paths:
        with open(p) as f:
            if p.endswith(".json"):
                data = json.load(f)
            else:
                import yaml

                data = yaml.safe_load(f) or {}
        cfg = cfg.merged_with(data)
    if overrides:
        cfg = cfg.override(overrides)
    return cfg
