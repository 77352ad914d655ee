"""Builtin dataset registrations (reference data/datasets/__init__.py:2-10;
`mp_former_tpu/data/datasets/builtin.py`): in the standard d2 layout under
$DETECTRON2_DATASETS, read once, when this module is first imported, the COCO
2017 instance splits (`coco.py`), and COCO panoptic, ADE20K, Cityscapes,
Mapillary Vistas, ADE20K-full and COCO-stuff-10k (`register_all.py`). A
caller that needs another root registers under a name of its own
(`register_coco_instances`, `register_coco_panoptic`, `register_sem_seg`,
`register_cityscapes_instance`, `register_cityscapes_panoptic`) or calls
`register_all_coco` / `register_all` / `register_more` with the root before
anything imports this module. LVIS waits for ROADMAP A16c."""

import os

from .coco import register_all_coco
from .register_all import register_all, register_more

_root = os.environ.get("DETECTRON2_DATASETS", "datasets")
register_all_coco(_root)
register_all(_root)
register_more(_root)
