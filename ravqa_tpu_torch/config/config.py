"""Config system: JSON/dict configs with inheritance and dotted overrides.

Replaces the reference's jsonnet stack (configs/**.jsonnet with
std.mergePatch inheritance, the reference's src/utils/config_system.py +
src/main.py:103-126). Differences by design:

- configs are JSON files (or plain dicts) with a `_base_` key (str or list)
  for recursive merge-patch inheritance instead of jsonnet imports;
- CLI `--opts a.b.c=value` overrides coerce via ast.literal_eval, NOT eval()
  (the reference's eval() at main.py:109 is a known defect, SURVEY.md §7);
- attribute access via Config (EasyDict-equivalent).

The port's own copy of ravqa_tpu/config/config.py (the port imports
nothing of the JAX package); tests/test_torch_host.py holds both to the
same dicts for every file in configs/.
"""

from __future__ import annotations

import ast
import copy
import json
import os
from typing import Any, Iterable


class Config(dict):
    """dict with recursive attribute access (EasyDict semantics)."""

    def __init__(self, d: dict | None = None, **kw):
        super().__init__()
        d = dict(d or {})
        d.update(kw)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, k, v):
        v = self._wrap(v)
        super().__setitem__(k, v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v
        return unwrap(self)


def merge_patch(base: dict, patch: dict) -> dict:
    """RFC7396-style recursive merge (jsonnet std.mergePatch semantics):
    dict values merge recursively, None deletes, others replace."""
    out = copy.deepcopy(dict(base))
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_patch(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Config:
    """Load a JSON config, resolving `_base_` inheritance recursively."""
    with open(path) as f:
        raw = json.load(f)
    bases = raw.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        bpath = b if os.path.isabs(b) else os.path.join(
            os.path.dirname(path), b)
        merged = merge_patch(merged, load_config(bpath).to_dict())
    return Config(merge_patch(merged, raw))


def apply_overrides(cfg: Config, opts: Iterable[str]) -> Config:
    """Apply `a.b.c=value` overrides (value via literal_eval, else string)."""
    cfg = Config(cfg.to_dict())
    for opt in opts:
        key, _, val = opt.partition("=")
        try:
            value = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            value = val
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value
    return cfg
