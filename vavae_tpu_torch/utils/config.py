"""Config: YAML load + dot-path overrides + attribute access.

Port of ``vavae_tpu/utils/config.py``. YAML is read and written by the
port's own ``utils/yaml_io.py`` (PyYAML is not needed, and not used where
it is installed); a ``.json`` base is read with ``json``. Override values
are parsed as YAML, as in the JAX package.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Iterable, Mapping

from vavae_tpu_torch.utils import yaml_io


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
        out = copy.deepcopy(self)
        for item in dotlist:
            key, _, raw = item.partition("=")
            node = out
            parts = key.strip().split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], Config):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = yaml_io.safe_load(raw)
        return out

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


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
            data = json.load(f) if p.endswith(".json") else yaml_io.safe_load(f) or {}
        cfg = cfg.merged_with(data)
    if overrides:
        cfg = cfg.override(overrides)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml_io.safe_dump(cfg.to_dict(), f, sort_keys=False)


def num_real_users(cfg: Config) -> int:
    """Number of real user classes a per-user generation loop iterates.

    ``data.num_classes`` counts only real users by default (the CFG null is
    the extra label-table row, id ``num_classes``). The micro-Doppler
    configs bake the null into ``num_classes`` (32 = 31 users + null):
    ``data.num_users`` names the real count explicitly, and a set
    ``sample.null_class`` (the reference's inference quirk) means
    ``num_classes - 1``."""
    explicit = cfg.get("data", {}).get("num_users")
    if explicit is not None:
        return int(explicit)
    if cfg.get("sample", {}).get("null_class") is not None:
        return int(cfg.data.num_classes) - 1
    return int(cfg.data.num_classes)
