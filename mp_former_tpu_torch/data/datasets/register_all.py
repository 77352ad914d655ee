"""COCO panoptic registrations (the port's copy of the COCO panoptic part of
`mp_former_tpu/data/datasets/register_all.py:62-130,251-272`; reference
register_coco_panoptic_annos_semseg.py and d2's builtin coco_2017_*_panoptic).
The ADE20K, Cityscapes and Mapillary registrations wait for a later slice of
the port (ROADMAP A16b).

Records: {file_name, pan_seg_file_name, segments_info (contiguous category
ids), image_id, height, width}, with `sem_seg_file_name` where a semantic root
is given and the instance `annotations` where an instance json is found.
The id maps and semantic maps may be `.npy` arrays of the same stem
(`tools/make_synthetic_coco_torch.py --panoptic`): the file names come from
the panoptic json.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog


def load_coco_panoptic_json(json_file: str, image_root: str, pan_root: str,
                            dataset_name: Optional[str] = None, semseg_root: Optional[str] = None,
                            instances_json: Optional[str] = None) -> List[Dict]:
    """Panoptic records; categories sorted by id and numbered contiguously
    (things and stuff alike); `dataset_name` also receives the class tables,
    `dataset_id_to_contiguous_id` and `thing_map` (contiguous id -> isthing)."""
    with open(json_file) as f:
        data = json.load(f)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    thing_map = {id_map[c["id"]]: bool(c.get("isthing", 0)) for c in cats}
    if dataset_name:
        MetadataCatalog.get(dataset_name).set(
            panoptic_classes=[c["name"] for c in cats],
            stuff_classes=[c["name"] for c in cats],
            thing_classes=[c["name"] for c in cats if c.get("isthing", 0)],
            dataset_id_to_contiguous_id=id_map,
            thing_dataset_id_to_contiguous_id={
                c["id"]: id_map[c["id"]] for c in cats if c.get("isthing", 0)},
            thing_map=thing_map)
    anns_by_img = {}
    if instances_json and os.path.isfile(instances_json):
        from .coco import load_coco_json

        anns_by_img = {r["image_id"]: r["annotations"]
                       for r in load_coco_json(instances_json, image_root)}
    img_by_id = {i["id"]: i for i in data["images"]}
    records = []
    for ann in data["annotations"]:
        img = img_by_id[ann["image_id"]]
        rec = {
            "file_name": os.path.join(image_root, img["file_name"].replace(".png", ".jpg")),
            "pan_seg_file_name": os.path.join(pan_root, ann["file_name"]),
            "segments_info": [dict(s, category_id=id_map[s["category_id"]])
                              for s in ann["segments_info"]],
            "image_id": ann["image_id"],
            "height": img["height"],
            "width": img["width"],
        }
        if semseg_root:
            rec["sem_seg_file_name"] = os.path.join(semseg_root, ann["file_name"])
        if ann["image_id"] in anns_by_img:
            rec["annotations"] = anns_by_img[ann["image_id"]]
        records.append(rec)
    return records


def register_coco_panoptic(name: str, json_file: str, image_root: str, pan_root: str,
                           evaluator_type: str = "coco_panoptic_seg",
                           semseg_root: Optional[str] = None,
                           instances_json: Optional[str] = None, **extra_meta) -> None:
    DatasetCatalog.register(
        name, lambda: load_coco_panoptic_json(json_file, image_root, pan_root, name, semseg_root,
                                              instances_json))
    extra_meta.setdefault("sem_seg_root", semseg_root)
    MetadataCatalog.get(name).set(evaluator_type=evaluator_type, panoptic_json=json_file,
                                  panoptic_root=pan_root, image_root=image_root, **extra_meta)


def register_all_coco_panoptic(root: Optional[str] = None) -> None:
    """`coco_2017_{train,val}_panoptic` and `..._with_sem_seg` (with the
    semantic maps under `coco/panoptic_semseg_<split>` and the instance json
    for AP) in the standard layout under `root` ($DETECTRON2_DATASETS, else
    `datasets`); a name already registered is left as it is."""
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    for split in ("train2017", "val2017"):
        name = f"coco_2017_{split.replace('2017', '')}_panoptic"
        json_file = os.path.join(root, f"coco/annotations/panoptic_{split}.json")
        image_root = os.path.join(root, f"coco/{split}")
        pan_root = os.path.join(root, f"coco/panoptic_{split}")
        if name not in DatasetCatalog:
            register_coco_panoptic(name, json_file, image_root, pan_root)
        if name + "_with_sem_seg" not in DatasetCatalog:
            register_coco_panoptic(
                name + "_with_sem_seg", json_file, image_root, pan_root,
                semseg_root=os.path.join(root, f"coco/panoptic_semseg_{split}"),
                instances_json=os.path.join(root, f"coco/annotations/instances_{split}.json"),
                ignore_label=255)
