"""Minimal DAG data pipeline over a transform registry.

Port of ravqa_tpu/data/pipeline.py without the on-disk node cache: named
transform nodes with `input_node` edges, `transform_name` dispatch through
the registry, per-node `setup_kwargs`, and `get_data([nodes])` running the
topological closure. Transforms subclass BaseTransform: setup(**kwargs),
then __call__(*inputs).
"""

from __future__ import annotations

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
    "setup_kwargs": dict}}"""

    def __init__(self, config: dict):
        self.config = dict(config)
        self.outputs: dict[str, Any] = {}

    def _node_inputs(self, name: str) -> list[str]:
        inp = self.config[name].get("input_node") or []
        return [inp] if isinstance(inp, str) else list(inp)

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
        inputs = []
        for dep in self._node_inputs(name):
            self._run(dep, visiting)
            inputs.append(self.outputs[dep])
        tname = spec["transform_name"]
        if tname not in TRANSFORM_REGISTRY:
            raise KeyError(f"transform {tname!r} not registered "
                           f"(have: {sorted(TRANSFORM_REGISTRY)})")
        t = TRANSFORM_REGISTRY[tname]()
        t.setup(**spec.get("setup_kwargs", {}))
        self.outputs[name] = t(*inputs)
        visiting.discard(name)
