"""Dataset and metadata catalogs (detectron2's DatasetCatalog and
MetadataCatalog; the port's own copy of `mp_former_tpu/data/catalog.py`)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._registry:
            raise ValueError(f"dataset {name} already registered")
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        return self._registry[name]()

    def list(self):
        return sorted(self._registry)

    def __contains__(self, name):
        return name in self._registry


class Metadata:
    def __init__(self, name: str):
        self.name = name

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)


class _MetadataCatalog:
    def __init__(self):
        self._meta: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._meta:
            self._meta[name] = Metadata(name)
        return self._meta[name]

    def list(self):
        return sorted(self._meta)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
