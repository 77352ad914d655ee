"""COCO-format dataset loading without pycocotools (the record loader and the
`coco_2017_*` registration of `mp_former_tpu/data/datasets/coco.py`; the
other datasets are not registered in the port yet).

Produces d2-style per-image records: {file_name, height, width, image_id,
annotations: [{bbox (xywh), category_id (contiguous), segmentation,
iscrowd, area}]}, as d2's load_coco_json does.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog


def load_coco_json(json_file: str, image_root: str,
                   dataset_name: Optional[str] = None) -> List[dict]:
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.set(
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
            json_file=json_file,
            image_root=image_root,
        )

    anns_by_img: Dict[int, List[dict]] = defaultdict(list)
    for a in coco.get("annotations", []):
        anns_by_img[a["image_id"]].append(a)

    records = []
    for img in coco["images"]:
        if "file_name" in img:
            fname = img["file_name"]
        else:
            # LVIS v1 images carry only coco_url (http://.../train2017/000000391895.jpg):
            # keep the split directory, as d2's LVIS loader does
            fname = "/".join(img["coco_url"].split("/")[-2:])
        rec = {
            "file_name": os.path.join(image_root, fname),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
        }
        annos = []
        for a in anns_by_img.get(img["id"], []):
            obj = {
                "bbox": a["bbox"],
                "category_id": id_map[a["category_id"]],
                "iscrowd": a.get("iscrowd", 0),
                "segmentation": a.get("segmentation"),
                "area": a.get("area", 0),
            }
            annos.append(obj)
        rec["annotations"] = annos
        records.append(rec)
    return records


def register_coco_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco")


def register_all_coco(root: Optional[str] = None):
    """`coco_2017_train` and `coco_2017_val` in the standard layout under
    `root` ($DETECTRON2_DATASETS, else `datasets`); a name already registered
    is left as it is."""
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    for name, (json_rel, img_rel) in {
        "coco_2017_train": ("coco/annotations/instances_train2017.json", "coco/train2017"),
        "coco_2017_val": ("coco/annotations/instances_val2017.json", "coco/val2017"),
    }.items():
        if name not in DatasetCatalog:
            register_coco_instances(name, os.path.join(root, json_rel), os.path.join(root, img_rel))
