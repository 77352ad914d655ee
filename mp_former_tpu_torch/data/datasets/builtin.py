"""Builtin dataset registrations (reference data/datasets/__init__.py:2-10;
`mp_former_tpu/data/datasets/builtin.py`): the COCO 2017 instance splits in
the standard d2 layout under $DETECTRON2_DATASETS, read once, when this
module is first imported. A caller that needs another root registers under
a name of its own (`register_coco_instances`) or calls `register_all_coco`
with the root before anything imports this module. The other datasets wait
for a later slice of the port (ROADMAP A16)."""

from .coco import register_all_coco

register_all_coco()
