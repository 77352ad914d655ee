"""Dataset category tables (names / colors / isthing / id maps).

The reference inlines these as Python literals in its register_* modules
(e.g. register_ade20k_full.py — a 964-line file that is mostly the 847-class
table). They are JSON data files under metadata/, copies of the JAX
package's `mp_former_tpu/data/datasets/metadata/*.json` (written by
tools/extract_reference_metadata.py), exposed here as d2-style metadata
dicts; the port's own copy of `mp_former_tpu/data/datasets/metadata.py`.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List

_DIR = os.path.join(os.path.dirname(__file__), "metadata")


@functools.lru_cache(maxsize=None)
def _load(name: str) -> List[dict]:
    with open(os.path.join(_DIR, name + ".json")) as f:
        return json.load(f)


def ade20k_full_classes() -> List[str]:
    """847 class names ordered by trainId (reference
    register_ade20k_full.py:7-853)."""
    cats = sorted(_load("ade20k_full_categories"), key=lambda c: c["trainId"])
    return [c["name"] for c in cats]


def ade20k_150_meta() -> Dict:
    """ADE20K panoptic metadata (reference register_ade20k_panoptic.py
    get_metadata :326-368): 150 stuff classes, 100 thing classes, colors,
    dataset-id maps. `thing_map` keys contiguous class index -> isthing."""
    cats = _load("ade20k_150_categories")
    return {
        "thing_classes": [c["name"] for c in cats if c["isthing"] == 1],
        "thing_colors": [c["color"] for c in cats if c["isthing"] == 1],
        "stuff_classes": [c["name"] for c in cats],
        "stuff_colors": [c["color"] for c in cats],
        "thing_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(cats) if c["isthing"]},
        "stuff_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(cats)},
        "thing_map": {i: bool(c["isthing"]) for i, c in enumerate(cats)},
    }


def ade20k_instance_meta() -> Dict:
    """100 ADE20K thing classes (reference register_ade20k_instance.py:12,
    _get_ade_instances_meta :28-38)."""
    cats = _load("ade20k_instance_categories")
    return {
        "thing_classes": [c["name"] for c in cats],
        "thing_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(cats)},
    }


def coco_stuff_171_classes() -> List[str]:
    """COCO-stuff-10k 171 contiguous classes (reference
    register_coco_stuff_10k.py:7-180, _get_coco_stuff_meta :182-197)."""
    cats = _load("coco_stuff_171_categories")
    return [c["name"] for c in cats]


def mapillary_sem_seg_meta() -> Dict:
    """Mapillary Vistas semantic: the 65 evaluated classes + colors
    (reference register_mapillary_vistas.py:7-471, meta :473-485)."""
    cats = [c for c in _load("mapillary_vistas_sem_seg_categories")
            if c["evaluate"]]
    return {
        "stuff_classes": [c["readable"] for c in cats],
        "stuff_colors": [c["color"] for c in cats],
    }


def mapillary_panoptic_meta() -> Dict:
    """Mapillary Vistas panoptic 65 categories with isthing
    (reference register_mapillary_vistas_panoptic.py:9-336, get_metadata
    :445-486 — note thing/stuff id maps share the full range there too)."""
    cats = _load("mapillary_vistas_panoptic_categories")
    return {
        "thing_classes": [c["name"] for c in cats if c["isthing"] == 1],
        "thing_colors": [c["color"] for c in cats if c["isthing"] == 1],
        "stuff_classes": [c["name"] for c in cats],
        "stuff_colors": [c["color"] for c in cats],
        "thing_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(cats) if c["isthing"]},
        "stuff_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(cats)},
        "thing_map": {i: bool(c["isthing"]) for i, c in enumerate(cats)},
    }
