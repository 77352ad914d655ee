"""YouTube-VIS records and registrations (reference
mask2former_video/data_video/datasets/ytvis.py; the port's copy of
`mp_former_tpu/video/ytvis.py:24-119`).

The COCO-style YTVIS json is parsed directly (no ytvos API). A video record
is {video_id, file_names (one per frame), height, width, length,
annotations: [{id, category_id (contiguous), segmentations (one per frame:
polygons, an RLE, or None where the object is absent), iscrowd, areas}]}.
Frames follow the `.npy` rule (`data/datasets/register_all.py`): a frame the
json names `<stem>.jpg` is read from `<stem>.npy`, (H, W, 3) uint8 BGR, where
only that is on disk. Polygons are rasterised by `native/maskapi.cc`, the JAX
package's rule. The clip mappers of training (`YTVISDatasetMapper`,
`CocoClipDatasetMapper`) are ROADMAP A20b.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.register_all import existing
from ..native import polygons_to_mask


def load_ytvis_json(json_file: str, image_root: str, dataset_name=None) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name:
        MetadataCatalog.get(dataset_name).set(
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map)
    anns_by_vid: Dict[int, List[dict]] = {}
    for a in data.get("annotations", []):
        anns_by_vid.setdefault(a["video_id"], []).append(a)
    records = []
    for v in data["videos"]:
        records.append({
            "video_id": v["id"],
            "file_names": [existing(os.path.join(image_root, f)) for f in v["file_names"]],
            "height": v["height"],
            "width": v["width"],
            "length": v["length"],
            "annotations": [
                {
                    "id": a["id"],
                    "category_id": id_map[a["category_id"]],
                    "segmentations": a.get("segmentations"),
                    "iscrowd": a.get("iscrowd", 0),
                    "areas": a.get("areas"),
                }
                for a in anns_by_vid.get(v["id"], [])
            ],
        })
    return records


def register_ytvis_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(name, lambda: load_ytvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="ytvis")


def register_all_ytvis(root: Optional[str] = None):
    """`ytvis_{2019,2021}_{train,val}` in the standard layout under `root`
    ($DETECTRON2_DATASETS, else `datasets`); a name already registered is left
    as it is."""
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    for name, (json_rel, img_rel) in {
        "ytvis_2019_train": ("ytvis_2019/train.json", "ytvis_2019/train/JPEGImages"),
        "ytvis_2019_val": ("ytvis_2019/valid.json", "ytvis_2019/valid/JPEGImages"),
        "ytvis_2021_train": ("ytvis_2021/train.json", "ytvis_2021/train/JPEGImages"),
        "ytvis_2021_val": ("ytvis_2021/valid.json", "ytvis_2021/valid/JPEGImages"),
    }.items():
        if name not in DatasetCatalog:
            register_ytvis_instances(
                name, os.path.join(root, json_rel), os.path.join(root, img_rel))


def _decode_compressed_counts(s) -> List[int]:
    """pycocotools rleFrString: 6-bit chunks (ASCII offset 48), sign
    extension on the 0x10 bit, counts delta-coded against counts[i-2]
    from the 4th element on."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _seg_to_mask(seg, h, w) -> Optional[np.ndarray]:
    """One frame's segmentation -> (h, w) bool, or None where the object is
    absent: polygons, or an RLE with compressed (string) or plain counts
    (column-major runs, background first)."""
    if seg is None:
        return None
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict) and seg.get("counts") is not None:
        counts = seg["counts"]
        if isinstance(counts, (str, bytes)):  # compressed RLE
            counts = _decode_compressed_counts(counts)
        mh, mw = seg["size"]
        flat = np.zeros(mh * mw, np.uint8)
        pos, val = 0, 0
        for c in counts:
            flat[pos:pos + c] = val
            pos += c
            val = 1 - val
        return flat.reshape(mw, mh).T.astype(bool)
    return None
