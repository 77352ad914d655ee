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
package's rule.

Training (`mp_former_tpu/video/ytvis.py:122-225`, the root
`train_net_video.py:99-120`): `YTVISDatasetMapper` samples a clip and maps it
to the JAX package's static canvas, `CocoClipDatasetMapper` repeats a COCO
image into a clip, `collate_clips` stacks clips into a `Batch` of
`VideoTargets`, and `build_clip_loader` puts them behind the `TrainLoader`.
"""

from __future__ import annotations

import json
import os
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.datasets.register_all import existing
from ..data.loader import TrainLoader
from ..data.transforms import apply_record_to_image, apply_to_sem_seg, resize_shortest_edge
from ..engine.eval_loop import read_image
from ..native import polygons_to_mask
from ..structures import Batch, VideoTargets


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


class YTVISDatasetMapper:
    """A video record -> a clip sample of the JAX package's static shape
    (`mp_former_tpu/video/ytvis.py:122-196`). Draws from the sample's
    `RandomState`, in the JAX order: the reference frame, the other
    SAMPLING_FRAME_NUM - 1 frames chosen within +-SAMPLING_FRAME_RANGE of it
    (the only frame again in a video of one), their shuffle where
    SAMPLING_FRAME_SHUFFLE says, then the short side from MIN_SIZE_TRAIN
    (long side capped at MAX_SIZE_TRAIN) and a flip with probability 1/2, the
    same for every frame of the clip. As in the JAX mapper,
    MIN_SIZE_TRAIN_SAMPLING and RANDOM_FLIP are not read, and the frames are
    RGB whatever INPUT.FORMAT says. Every clip lies on one canvas,
    max(MIN_SIZE_TRAIN) by MAX_SIZE_TRAIN rounded up to 32 (transposed for a
    portrait video), padded with 128. A slot a non-crowd annotation, at most
    `max_instances`: its mask in each sampled frame at full resolution
    (nearest resize), its label, valid where the object is in some sampled
    frame, so an invalid slot may lie between valid ones. Returns None where
    a frame cannot be read."""

    def __init__(self, cfg, max_instances: int = 40):
        self.num_frames = cfg.INPUT.SAMPLING_FRAME_NUM
        self.frame_range = cfg.INPUT.SAMPLING_FRAME_RANGE
        self.shuffle = cfg.INPUT.SAMPLING_FRAME_SHUFFLE
        self.min_sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN
        self.max_instances = max_instances
        self.size_div = 32

    def __call__(self, record: dict, rng: np.random.RandomState) -> Optional[dict]:
        length = record["length"]
        ref = rng.randint(length)
        lo = max(0, ref - self.frame_range)
        hi = min(length, ref + self.frame_range + 1)
        pool = [i for i in range(lo, hi) if i != ref] or [ref]
        picks = sorted([ref] + list(rng.choice(
            pool, self.num_frames - 1, replace=len(pool) < self.num_frames - 1)))
        if self.shuffle:
            rng.shuffle(picks)

        h, w = record["height"], record["width"]
        rec = resize_shortest_edge(rng, h, w, self.min_sizes, self.max_size, flip=True)
        d = self.size_div
        short = (max(self.min_sizes) + d - 1) // d * d
        long = (self.max_size + d - 1) // d * d
        ph, pw = (short, long) if w >= h else (long, short)
        ph = max(ph, (rec.out_h + d - 1) // d * d)
        pw = max(pw, (rec.out_w + d - 1) // d * d)

        n_cap = self.max_instances
        frames = np.zeros((self.num_frames, ph, pw, 3), np.uint8)
        masks = np.zeros((n_cap, self.num_frames, ph, pw), bool)
        labels = np.zeros((n_cap,), np.int64)
        annos = [a for a in record["annotations"] if not a.get("iscrowd", 0)][:n_cap]
        for fi, frame_idx in enumerate(picks):
            img = read_image({"file_name": record["file_names"][frame_idx]})
            if img is None:
                return None
            out = apply_record_to_image(img[:, :, ::-1], rec, pad_value=128.0)
            frames[fi, :out.shape[0], :out.shape[1]] = out
            for ai, a in enumerate(annos):
                segs = a.get("segmentations")
                m = _seg_to_mask(segs[frame_idx], h, w) if segs else None
                if m is None:
                    continue
                tm = apply_to_sem_seg(m, rec, False)
                masks[ai, fi, :tm.shape[0], :tm.shape[1]] = tm
                labels[ai] = a["category_id"]
        valid = masks.any(axis=(1, 2, 3))
        return {"image": frames, "labels": labels, "masks": masks, "valid": valid,
                "video_id": record["video_id"], "height": h, "width": w}


class CocoClipDatasetMapper:
    """A COCO image -> a clip of SAMPLING_FRAME_NUM copies of it
    (`mp_former_tpu/video/ytvis.py:199-225`, reference
    data_video/dataset_mapper.py:272), through the LSJ instance mapper: one
    transform for the whole clip, every tube the image's mask in each
    frame."""

    def __init__(self, cfg, is_train: bool = True, max_instances: int = 40):
        from ..data.dataset_mappers.coco_instance_new_baseline import \
            COCOInstanceNewBaselineDatasetMapper

        self.num_frames = cfg.INPUT.SAMPLING_FRAME_NUM
        self._image_mapper = COCOInstanceNewBaselineDatasetMapper(
            cfg, is_train=is_train, max_instances=max_instances)

    def __call__(self, record: dict, rng: np.random.RandomState) -> Optional[dict]:
        s = self._image_mapper(record, rng)
        if s is None:
            return None
        t = self.num_frames
        return {"image": np.repeat(s["image"][None], t, axis=0), "labels": s["labels"],
                "masks": np.repeat(s["masks"][:, None], t, axis=1), "valid": s["valid"],
                "video_id": record.get("image_id", -1), "height": s["height"],
                "width": s["width"]}


def collate_clips(samples: List[Dict], pin_memory: bool = False) -> Batch:
    """Clip samples -> a `Batch` of uint8 clips (B, T, H, W, 3) and
    `VideoTargets` (int64 labels, bool masks and valid), pinned where asked.
    The slot axis is cut after the batch's last valid slot (one slot where
    none is valid): the clips' ground truth is at full resolution, and the
    JAX package's cap of TPU.MAX_INSTANCES slots would copy and convert
    gigabytes of empty tubes a step. An invalid slot costs every query the
    same in the matcher and enters no loss, so the cut changes no loss (up to
    exact ties in the assignment); it keeps invalid slots between valid ones."""
    valid = np.stack([s["valid"] for s in samples])
    n = max(1, int(np.flatnonzero(valid.any(0)).max(initial=-1)) + 1)

    def stack(arrays, dtype):
        t = torch.from_numpy(np.stack(arrays).astype(dtype, copy=False))
        return t.pin_memory() if pin_memory else t

    return Batch(stack([s["image"] for s in samples], np.uint8),
                 VideoTargets(stack([s["labels"][:n] for s in samples], np.int64),
                              stack([s["masks"][:n] for s in samples], bool),
                              stack([s["valid"][:n] for s in samples], bool)))


def build_clip_loader(cfg, records: List[dict], pin_memory: bool = False, rank: int = 0,
                      world_size: int = 1) -> TrainLoader:
    """The training loader of the video entry point (the root
    `train_net_video.py:99-120`): `records` through `YTVISDatasetMapper` with
    TPU.MAX_INSTANCES slots, SOLVER.IMS_PER_BATCH clips a batch,
    `collate_clips`; rank `rank` of `world_size` takes its block of every
    batch (cut after its own last valid slot: the step pads the ranks' slot
    axes to the largest, `engine/train_step.py`)."""
    mapper = YTVISDatasetMapper(cfg, max_instances=cfg.TPU.MAX_INSTANCES)
    return TrainLoader(records, mapper, cfg.SOLVER.IMS_PER_BATCH, seed=max(cfg.SEED, 0),
                       num_workers=cfg.DATALOADER.NUM_WORKERS,
                       filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
                       collate_fn=functools.partial(collate_clips, pin_memory=pin_memory),
                       rank=rank, world_size=world_size)
