"""DAG data pipeline over a transform registry, with an on-disk node cache.

Port of ravqa_tpu/data/pipeline.py (:43-127): named transform nodes with
`input_node` edges, `transform_name` dispatch through the registry,
per-node `setup_kwargs`, `cache` / `regenerate` flags, `global_config` on
each transform, and `get_data([nodes])` running the topological closure.
Transforms subclass BaseTransform: setup(**kwargs), then __call__(*inputs).

A node with `cache` true is pickled under `cache_dir` as
`<node>.<key>.torch.pkl` and read back on the next run unless it sets
`regenerate`. The key is the JAX package's `_cache_key` (the node's name,
transform, setup kwargs and its inputs' keys), so one config gives one key
in both packages; the `.torch` in the name keeps each package from reading
the other's pickles, whose objects are its own classes (a JAX pickle
imports ravqa_tpu).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Optional

TRANSFORM_REGISTRY: dict[str, type] = {}


def register_transform(cls=None, *, name: Optional[str] = None):
    """Class decorator adding a transform to the registry by class name."""
    def wrap(c):
        TRANSFORM_REGISTRY[name or c.__name__] = c
        return c
    return wrap(cls) if cls is not None else wrap


class BaseTransform:
    """setup(**setup_kwargs) once; __call__(*inputs) -> node output."""

    def setup(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __call__(self, *inputs):
        raise NotImplementedError


class DataPipeline:
    """config: {node_name: {"transform_name": str, "input_node": str|list,
    "setup_kwargs": dict, "cache": bool, "regenerate": bool}}"""

    def __init__(self, config: dict, cache_dir: Optional[str] = None,
                 global_config: Optional[dict] = None):
        self.config = dict(config)
        self.cache_dir = cache_dir
        self.global_config = global_config
        self.outputs: dict[str, Any] = {}

    def _node_inputs(self, name: str) -> list[str]:
        inp = self.config[name].get("input_node") or []
        return [inp] if isinstance(inp, str) else list(inp)

    def _cache_key(self, name: str) -> str:
        """sha1 of the node's name, transform, setup kwargs (a callable or
        an object whose repr holds its address keyed by its type's name,
        so the key is stable across processes) and its inputs' keys."""
        spec = self.config[name]

        def stable(v):
            if callable(v) or " object at 0x" in repr(v):
                return f"<{type(v).__name__}>"
            if isinstance(v, dict):
                return {k: stable(x) for k, x in sorted(v.items())}
            if isinstance(v, (list, tuple)):
                return [stable(x) for x in v]
            return v

        payload = repr((name, spec.get("transform_name"),
                        sorted((k, stable(v)) for k, v in
                               spec.get("setup_kwargs", {}).items()),
                        [self._cache_key(i) for i in self._node_inputs(name)]))
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def _cache_path(self, name: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir,
                            f"{name}.{self._cache_key(name)}.torch.pkl")

    def get_data(self, nodes: list[str] | str, explode: bool = False):
        """Run the topological closure of `nodes`; return {node: output}."""
        if isinstance(nodes, str):
            nodes = [nodes]
        for n in nodes:
            self._run(n, set())
        out = {n: self.outputs[n] for n in nodes}
        if explode and len(nodes) == 1:
            return out[nodes[0]]
        return out

    def _run(self, name: str, visiting: set):
        if name in self.outputs:
            return
        if name in visiting:
            raise ValueError(f"cycle at node {name}")
        visiting.add(name)
        spec = self.config[name]
        path = self._cache_path(name)
        if (spec.get("cache", False) and not spec.get("regenerate", False)
                and path and os.path.exists(path)):
            with open(path, "rb") as f:
                self.outputs[name] = pickle.load(f)
            return
        inputs = []
        for dep in self._node_inputs(name):
            self._run(dep, visiting)
            inputs.append(self.outputs[dep])
        tname = spec["transform_name"]
        if tname not in TRANSFORM_REGISTRY:
            raise KeyError(f"transform {tname!r} not registered "
                           f"(have: {sorted(TRANSFORM_REGISTRY)})")
        t = TRANSFORM_REGISTRY[tname]()
        t.global_config = self.global_config
        t.setup(**spec.get("setup_kwargs", {}))
        result = t(*inputs)
        self.outputs[name] = result
        if spec.get("cache", False) and path:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(result, f)
        visiting.discard(name)
