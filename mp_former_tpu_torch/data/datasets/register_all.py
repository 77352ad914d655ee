"""Dataset registrations beyond COCO instances (the port's copy of
`mp_former_tpu/data/datasets/register_all.py`; reference register_*.py and
the d2 builtins it relies on): COCO panoptic (with semantic ground truth),
ADE20K semantic, instance and panoptic, Cityscapes semantic, instance and
panoptic, Mapillary Vistas semantic and panoptic, ADE20K-full and
COCO-stuff-10k, in the standard d2 layout under $DETECTRON2_DATASETS. LVIS
(`lvis_v1_*`) is not registered yet (ROADMAP A16c).

Every registration sets `evaluator_type` to the value the reference's
build_evaluator dispatches on (reference train_net.py:142-222) and carries
the class, colour and isthing tables (`metadata.py`).

Records: panoptic ones {file_name, pan_seg_file_name, segments_info
(contiguous category ids), image_id, height, width}, with `sem_seg_file_name`
where a semantic root is given and the instance `annotations` where an
instance json is found; semantic ones {file_name, sem_seg_file_name,
image_id, height None, width None}; Cityscapes instance ones with the
polygons of `_gtFine_polygons.json` as `annotations` and the
`instance_id_file` / `label_id_file` the evaluators read.

The `.npy` rule (a machine without an image decoder): wherever a file of a
pair is named `<stem><ext>` (an image, a semantic map, an id map, a
`_gtFine_instanceIds` or `_gtFine_labelIds` map), `<stem>.npy` serves in its
place when the file itself is missing: images (H, W, 3) uint8 BGR, maps
(H, W) integers. On a tree of PNG and JPEG files the records equal the JAX
package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from . import metadata as M
from .builtin_meta import ADE20K_150_CLASSES
from .cityscapes_labels import EVAL_LABELS, INSTANCE_LABELS


def npy_twin(path: str) -> str:
    """`path` with its extension replaced by `.npy` (`x_leftImg8bit.png` ->
    `x_leftImg8bit.npy`)."""
    return os.path.splitext(path)[0] + ".npy"


def existing(path: str) -> str:
    """`path`, or its `.npy` twin where only the twin is on disk."""
    if not os.path.isfile(path):
        twin = npy_twin(path)
        if os.path.isfile(twin):
            return twin
    return path


def _paired_images(files: List[str], image_ext: str):
    """(file, stem) of each image among `files` (sorted): a name ending in
    `image_ext`, or in its `.npy` twin where no `image_ext` file has the
    same stem."""
    twin_ext = image_ext[: image_ext.rfind(".")] + ".npy"  # ".jpg" -> ".npy"
    names = set(files)
    for f in sorted(files):
        if f.endswith(image_ext):
            yield f, f[: -len(image_ext)]
        elif f.endswith(twin_ext) and f[: -len(twin_ext)] + image_ext not in names:
            yield f, f[: -len(twin_ext)]


def _file_pair_records(image_dir: str, gt_dir: str, image_ext: str,
                       gt_ext: str, gt_key: str) -> List[dict]:
    """Images paired with the ground truth file of the same stem, recursing
    into subdirectories (Cityscapes nests a folder a city)
    (`mp_former_tpu/data/datasets/register_all.py:22-46`, with the `.npy`
    rule)."""
    records = []
    if not os.path.isdir(image_dir):
        return records
    i = 0
    for cur, _dirs, files in sorted(os.walk(image_dir)):
        rel = os.path.relpath(cur, image_dir)
        for f, base in _paired_images(files, image_ext):
            gt = os.path.join(gt_dir, rel, base + gt_ext) if rel != "." \
                else os.path.join(gt_dir, base + gt_ext)
            records.append({
                "file_name": os.path.join(cur, f),
                gt_key: existing(gt),
                "image_id": i,
                "height": None,
                "width": None,
            })
            i += 1
    return records


def register_sem_seg(name: str, image_dir: str, gt_dir: str, classes: List[str],
                     ignore_label: int = 255, image_ext: str = ".jpg", gt_ext: str = ".png",
                     evaluator_type: str = "sem_seg", **extra_meta) -> None:
    DatasetCatalog.register(
        name, lambda: _file_pair_records(image_dir, gt_dir, image_ext, gt_ext,
                                         "sem_seg_file_name"))
    MetadataCatalog.get(name).set(
        stuff_classes=classes, ignore_label=ignore_label, evaluator_type=evaluator_type,
        image_root=image_dir, sem_seg_root=gt_dir, **extra_meta)


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
            "file_name": existing(
                os.path.join(image_root, img["file_name"].replace(".png", ".jpg"))),
            "pan_seg_file_name": existing(os.path.join(pan_root, ann["file_name"])),
            "segments_info": [dict(s, category_id=id_map[s["category_id"]])
                              for s in ann["segments_info"]],
            "image_id": ann["image_id"],
            "height": img["height"],
            "width": img["width"],
        }
        if semseg_root:
            rec["sem_seg_file_name"] = existing(os.path.join(semseg_root, ann["file_name"]))
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


# ---------------------------------------------------------------------------
# Cityscapes (the reference uses the d2 builtins cityscapes_fine_{instance_seg,
# sem_seg,panoptic}_{train,val})
# ---------------------------------------------------------------------------

def _poly_bbox(points) -> List[float]:
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    return [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)]


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """Instance records from the gtFine polygon annotations (d2
    load_cityscapes_instances; `mp_former_tpu/data/datasets/
    register_all.py:133-185`): `category_id` is the contiguous thing index
    (8 classes), a label with the suffix "group" is a crowd region of its
    class, and the `_gtFine_instanceIds` / `_gtFine_labelIds` maps of the
    official evaluation are attached."""
    name_to_contig = {lab.name: i for i, lab in enumerate(INSTANCE_LABELS)}
    records = []
    if not os.path.isdir(image_dir):
        return records
    i = 0
    for cur, _dirs, files in sorted(os.walk(image_dir)):
        rel = os.path.relpath(cur, image_dir)
        for f, base in _paired_images(files, "_leftImg8bit.png"):
            gtp = os.path.join(gt_dir, rel, base + "_gtFine_polygons.json")
            rec = {
                "file_name": os.path.join(cur, f),
                "image_id": i,
                "instance_id_file": existing(
                    os.path.join(gt_dir, rel, base + "_gtFine_instanceIds.png")),
                "label_id_file": existing(
                    os.path.join(gt_dir, rel, base + "_gtFine_labelIds.png")),
                "height": 1024,
                "width": 2048,
            }
            i += 1
            annos = []
            if os.path.isfile(gtp):
                with open(gtp) as fh:
                    poly = json.load(fh)
                rec["height"] = poly.get("imgHeight", 1024)
                rec["width"] = poly.get("imgWidth", 2048)
                for obj in poly.get("objects", []):
                    label = obj["label"]
                    iscrowd = 0
                    if label not in name_to_contig and label.endswith("group"):
                        label = label[: -len("group")]
                        iscrowd = 1
                    if label not in name_to_contig:
                        continue
                    annos.append({
                        "category_id": name_to_contig[label],
                        "segmentation": [[float(v) for pt in obj["polygon"] for v in pt]],
                        "iscrowd": iscrowd,
                        "bbox": _poly_bbox(obj["polygon"]),
                    })
            rec["annotations"] = annos
            records.append(rec)
    return records


def register_cityscapes_instance(name: str, image_dir: str, gt_dir: str) -> None:
    DatasetCatalog.register(name, lambda: load_cityscapes_instances(image_dir, gt_dir))
    MetadataCatalog.get(name).set(
        evaluator_type="cityscapes_instance",
        thing_classes=[lab.name for lab in INSTANCE_LABELS],
        image_root=image_dir, gt_root=gt_dir)


def _cityscapes_stem(file_name: str) -> str:
    """`<city>_<seq>_<frame>` of an image or panoptic file name:
    createPanopticImgs writes `<city>_<seq>_<frame>_leftImg8bit.png`, so both
    suffixes are stripped before one is added again."""
    stem = os.path.basename(file_name)
    for suf in (".jpg", ".png", ".npy"):
        if stem.endswith(suf):
            stem = stem[: -len(suf)]
    for suf in ("_gtFine_panoptic", "_leftImg8bit"):
        if stem.endswith(suf):
            stem = stem[: -len(suf)]
    return stem


def register_cityscapes_panoptic(name: str, image_dir: str, gt_dir: str, split: str) -> None:
    """cityscapes_fine_panoptic_* from gtFine/cityscapes_panoptic_{split}*
    (cityscapesscripts createPanopticImgs; `mp_former_tpu/data/datasets/
    register_all.py:203-245`): the image, labelTrainIds, instanceIds and
    labelIds files are the city-nested siblings of the json's names."""
    json_file = os.path.join(gt_dir, f"cityscapes_panoptic_{split}.json")
    pan_root = os.path.join(gt_dir, f"cityscapes_panoptic_{split}")

    def load():
        if not os.path.isfile(json_file):
            return []
        recs = load_coco_panoptic_json(json_file, image_dir, pan_root, name)
        for r in recs:
            stem = _cityscapes_stem(r["file_name"])
            city = stem.split("_")[0]
            gt = os.path.join(gt_dir, split, city, stem)
            r["file_name"] = existing(
                os.path.join(image_dir, split, city, stem + "_leftImg8bit.png"))
            r["sem_seg_file_name"] = existing(gt + "_gtFine_labelTrainIds.png")
            r["instance_id_file"] = existing(gt + "_gtFine_instanceIds.png")
            r["label_id_file"] = existing(gt + "_gtFine_labelIds.png")
        return recs

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(
        evaluator_type="cityscapes_panoptic_seg",
        panoptic_json=json_file, panoptic_root=pan_root,
        stuff_classes=[lab.name for lab in EVAL_LABELS],
        thing_classes=[lab.name for lab in EVAL_LABELS if lab.hasInstances],
        thing_map={lab.trainId: lab.hasInstances for lab in EVAL_LABELS},
        ignore_label=255, image_root=image_dir, gt_root=gt_dir)


# ---------------------------------------------------------------------------

def register_all(root: Optional[str] = None) -> None:
    """COCO panoptic, ADE20K (semantic, instance, panoptic), Cityscapes
    (semantic, instance, panoptic) and Mapillary Vistas panoptic in the
    standard layout under `root` ($DETECTRON2_DATASETS, else `datasets`;
    `mp_former_tpu/data/datasets/register_all.py:248-371` less LVIS, ROADMAP
    A16c); a name already registered is left as it is."""
    from .coco import register_coco_instances

    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    register_all_coco_panoptic(root)

    # ADE20K semantic (SceneParsing-150)
    for split, dirn in (("train", "training"), ("val", "validation")):
        name = f"ade20k_sem_seg_{split}"
        if name not in DatasetCatalog:
            register_sem_seg(
                name, os.path.join(root, f"ADEChallengeData2016/images/{dirn}"),
                os.path.join(root, f"ADEChallengeData2016/annotations_detectron2/{dirn}"),
                ADE20K_150_CLASSES, stuff_colors=M.ade20k_150_meta()["stuff_colors"])

    # ADE20K instance (reference register_ade20k_instance.py:41-50)
    ade_inst_meta = M.ade20k_instance_meta()
    for split, dirn in (("train", "training"), ("val", "validation")):
        name = f"ade20k_instance_{split}"
        if name not in DatasetCatalog:
            register_coco_instances(
                name, os.path.join(root, f"ADEChallengeData2016/ade20k_instance_{split}.json"),
                os.path.join(root, f"ADEChallengeData2016/images/{dirn}"))
            MetadataCatalog.get(name).set(**ade_inst_meta)

    # Cityscapes semantic / instance / panoptic
    for split in ("train", "val"):
        img = os.path.join(root, f"cityscapes/leftImg8bit/{split}")
        gt = os.path.join(root, f"cityscapes/gtFine/{split}")
        name = f"cityscapes_fine_sem_seg_{split}"
        if name not in DatasetCatalog:
            register_sem_seg(
                name, img, gt, [lab.name for lab in EVAL_LABELS],
                image_ext="_leftImg8bit.png", gt_ext="_gtFine_labelTrainIds.png",
                evaluator_type="cityscapes_sem_seg",
                gt_root=os.path.join(root, "cityscapes/gtFine"))
        name = f"cityscapes_fine_instance_seg_{split}"
        if name not in DatasetCatalog:
            register_cityscapes_instance(name, img, gt)
        name = f"cityscapes_fine_panoptic_{split}"
        if name not in DatasetCatalog:
            register_cityscapes_panoptic(name, os.path.join(root, "cityscapes/leftImg8bit"),
                                         os.path.join(root, "cityscapes/gtFine"), split)

    # ADE20K panoptic and Mapillary Vistas panoptic (reference
    # register_ade20k_panoptic.py, register_mapillary_vistas_panoptic.py)
    ade_pan_meta = M.ade20k_150_meta()
    map_pan_meta = M.mapillary_panoptic_meta()
    for name, (jf, ir, pr, et, meta) in {
        "ade20k_panoptic_train": (
            "ADEChallengeData2016/ade20k_panoptic_train.json",
            "ADEChallengeData2016/images/training", "ADEChallengeData2016/ade20k_panoptic_train",
            "ade20k_panoptic_seg", ade_pan_meta),
        "ade20k_panoptic_val": (
            "ADEChallengeData2016/ade20k_panoptic_val.json",
            "ADEChallengeData2016/images/validation", "ADEChallengeData2016/ade20k_panoptic_val",
            "ade20k_panoptic_seg", ade_pan_meta),
        "mapillary_vistas_panoptic_train": (
            "mapillary_vistas/training/panoptic/panoptic_2018.json",
            "mapillary_vistas/training/images", "mapillary_vistas/training/panoptic",
            "mapillary_vistas_panoptic_seg", map_pan_meta),
        "mapillary_vistas_panoptic_val": (
            "mapillary_vistas/validation/panoptic/panoptic_2018.json",
            "mapillary_vistas/validation/images", "mapillary_vistas/validation/panoptic",
            "mapillary_vistas_panoptic_seg", map_pan_meta),
    }.items():
        # records without semantic (or instance) ground truth, as the JAX
        # package registers them (ROADMAP §C)
        if name not in DatasetCatalog:
            kw = dict(meta)
            if "ade20k" in name:
                kw["sem_seg_root"] = os.path.join(
                    root, "ADEChallengeData2016/annotations_detectron2",
                    "training" if name.endswith("train") else "validation")
                kw["ignore_label"] = 255
            else:
                kw["ignore_label"] = 65
            register_coco_panoptic(name, os.path.join(root, jf), os.path.join(root, ir),
                                   os.path.join(root, pr), evaluator_type=et, **kw)


def register_more(root: Optional[str] = None) -> None:
    """ADE20K-full (847 classes), COCO-stuff-10k and Mapillary Vistas
    semantic (reference register_ade20k_full.py, register_coco_stuff_10k.py,
    register_mapillary_vistas.py; `mp_former_tpu/data/datasets/
    register_all.py:374-420`), with the class tables of `metadata.py`."""
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    map_meta = M.mapillary_sem_seg_meta()
    map_extra = {"stuff_colors": map_meta["stuff_colors"]}
    specs = {
        "ade20k_full_sem_seg_train": (
            "ADE20K_2021_17_01/images_detectron2/training",
            "ADE20K_2021_17_01/annotations_detectron2/training",
            M.ade20k_full_classes(), 65535, {}),
        "ade20k_full_sem_seg_val": (
            "ADE20K_2021_17_01/images_detectron2/validation",
            "ADE20K_2021_17_01/annotations_detectron2/validation",
            M.ade20k_full_classes(), 65535, {}),
        "coco_2017_train_stuff_10k_sem_seg": (
            "coco_stuff_10k/images_detectron2/train", "coco_stuff_10k/annotations_detectron2/train",
            M.coco_stuff_171_classes(), 255, {}),
        "coco_2017_test_stuff_10k_sem_seg": (
            "coco_stuff_10k/images_detectron2/test", "coco_stuff_10k/annotations_detectron2/test",
            M.coco_stuff_171_classes(), 255, {}),
        "mapillary_vistas_sem_seg_train": (
            "mapillary_vistas/training/images", "mapillary_vistas/training/labels",
            map_meta["stuff_classes"], 65, map_extra),
        "mapillary_vistas_sem_seg_val": (
            "mapillary_vistas/validation/images", "mapillary_vistas/validation/labels",
            map_meta["stuff_classes"], 65, map_extra),
    }
    for name, (img, gt, classes, ignore, extra) in specs.items():
        if name not in DatasetCatalog:
            register_sem_seg(name, os.path.join(root, img), os.path.join(root, gt), classes,
                             ignore_label=ignore, **extra)
