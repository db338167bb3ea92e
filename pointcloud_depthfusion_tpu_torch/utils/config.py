"""Config system: YAML trees with defaults-override + dotted-path updates.

The port's own copy of pointcloud_depthfusion_tpu/utils/config.py (the
port imports nothing of the JAX package).

Reproduces the reference's three config tiers (SURVEY.md §5):
  1. per-node YAML with the `config.yaml`-overrides-`config_default.yaml`
     convention (camera_node/launch/camera_left.launch.py:19-28);
  2. runtime parameters with dotted-namespace dynamic reconfiguration
     (`sensor.color.*`, `debug.*` — config.cpp:53-169) →
     :meth:`ConfigTree.set` with dotted paths + change callbacks;
  3. argv flags — handled by the node mains (nodes/*.py argparse).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import yaml


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class ConfigTree:
    """A nested parameter tree with dotted-path access and callbacks."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = data or {}
        self._callbacks: List[Callable[[str, Any], None]] = []

    # -- loading -----------------------------------------------------------

    @staticmethod
    def load(
        default_path: Optional[str] = None,
        override_path: Optional[str] = None,
        node_key: Optional[str] = None,
    ) -> "ConfigTree":
        """Load default + optional override YAML, optionally descending into
        ``<node_key>: ros__parameters:`` (the reference file layout) or a
        plain ``<node_key>:`` section."""
        data: Dict[str, Any] = {}
        for path in (default_path, override_path):
            if not path:
                continue
            try:
                with open(path) as fh:
                    loaded = yaml.safe_load(fh) or {}
            except FileNotFoundError:
                continue
            data = _deep_merge(data, loaded)
        if node_key and node_key in data:
            section = data[node_key]
            if isinstance(section, dict) and "ros__parameters" in section:
                section = section["ros__parameters"]
            data = section
        return ConfigTree(data)

    # -- access ------------------------------------------------------------

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, dotted: str, value: Any) -> None:
        """Dynamic reconfiguration: set a dotted parameter and notify
        subscribers (the add_on_set_parameters_callback equivalent)."""
        parts = dotted.split(".")
        node = self._data
        for i, part in enumerate(parts[:-1]):
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                # A scalar leaf in the path: without this check the next
                # step raises an opaque "'int' object does not support
                # item assignment" with no hint which parameter collided.
                raise ValueError(
                    f"cannot set {dotted!r}: "
                    f"{'.'.join(parts[:i + 1])!r} is a scalar "
                    f"({node!r}), not a namespace"
                )
        node[parts[-1]] = value
        for cb in self._callbacks:
            cb(dotted, value)

    def on_change(self, callback: Callable[[str, Any], None]) -> None:
        self._callbacks.append(callback)

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def declare(self, dotted: str, default: Any) -> Any:
        """declare_parameter semantics: return existing or install default."""
        current = self.get(dotted, None)
        if current is None:
            self.set(dotted, default)
            return default
        return current
