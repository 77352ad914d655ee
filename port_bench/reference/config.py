"""A configuration as nested attributes, for the reference's `from_config`
methods: `Node.of({"MODEL": {"MASK_FORMER": {...}}})`."""

from __future__ import annotations

from typing import Any, Dict


class Node(dict):
    """A dict whose keys read as attributes; a key that is not there raises
    `KeyError` with its full path, so a reference that reads a key that the
    configuration file does not give fails loudly."""

    def __init__(self, items: Dict[str, Any], path: str = ""):
        super().__init__({k: Node(v, f"{path}{k}.") if isinstance(v, dict) else v
                          for k, v in items.items()})
        self._path = path

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise KeyError(f"the configuration file's cfg block has no {self._path}{name}")

    def get(self, name: str, default: Any = None) -> Any:
        return super().get(name, default)


def flatten(node: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{"A": {"B": 1}} -> {"A.B": 1}."""
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
