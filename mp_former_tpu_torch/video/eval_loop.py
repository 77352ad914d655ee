"""Whole-clip video inference and its evaluation (reference train_net_video.py's
evaluation, video_maskformer_model.py:255-287 `inference_video` and the
YTVIS evaluator; `mp_former_tpu/video/eval_loop.py:20-188`).

Each clip runs in one forward at its own length: PyTorch runs eagerly, so
the JAX package's static length buckets, padding frames and per-bucket jit
cache (`t_bucket`, `make_clip_forward`, `_clip_forward`) have no counterpart.
Across data-parallel ranks the clips are sharded and the evaluators merged
(`parallel/dist.py:sharded_eval_loop`).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.transforms import _resize_image
from ..engine.eval_loop import read_image
from ..parallel.dist import sharded_eval_loop
from ..utils.interp import resize
from .ytvis_eval import YTVISEvaluator

logger = logging.getLogger(__name__)


def inference_video(logits: torch.Tensor, masks: torch.Tensor, img_size: Tuple[int, int],
                    out_h: int, out_w: int, num_classes: int, topk: int = 10):
    """One clip's (Q, K+1) class logits and (Q, T, h4, w4) mask logits -> the
    top-k tubes at the original size: (scores (topk,) float64, classes
    (topk,) int64, tubes (topk, T, out_h, out_w) bool), as numpy arrays. The
    scores are a float64 softmax on the host, as in the JAX package, so that
    near-ties order as there; the chosen queries' masks are upsampled x4 to
    the padded canvas, cropped to the resized clip `img_size` and resized to
    (out_h, out_w) on the masks' device, and the tubes cross to the host in
    one copy."""
    scores = logits.detach().double().cpu().numpy()
    scores = np.exp(scores - scores.max(-1, keepdims=True))
    scores = (scores / scores.sum(-1, keepdims=True))[:, :-1]
    flat = scores.reshape(-1)
    top = np.argsort(-flat)[:topk]
    tube_q = torch.from_numpy(top // num_classes).to(masks.device)
    sel = masks[tube_q]
    m = resize(sel, (sel.shape[2] * 4, sel.shape[3] * 4), "bilinear")
    m = resize(m[:, :, :img_size[0], :img_size[1]], (out_h, out_w), "bilinear")
    return flat[top], (top % num_classes).astype(np.int64), (m > 0).cpu().numpy()


def prep_clip(cfg, rec: dict, max_frames: Optional[int] = None) -> Optional[dict]:
    """Read, resize and pad one clip record (reference/d2 ResizeShortestEdge
    at MIN_SIZE_TEST with the long side capped at MAX_SIZE_TEST): its first
    `max_frames` frames (all by default), BGR `.npy` (or decoded) frames
    turned to RGB and resized with `data/transforms.py:_resize_image` (cv2's
    bilinear rule, rounded to uint8), on a canvas padded with the pixel mean
    to a multiple of 32. Returns {"rec", "t", "rh", "rw", "clip" (T, H', W',
    3) float32}, or None where a frame cannot be read."""
    t = rec["length"] if max_frames is None else min(rec["length"], max_frames)
    h, w = rec["height"], rec["width"]
    scale = cfg.INPUT.MIN_SIZE_TEST / min(h, w)
    if max(h, w) * scale > cfg.INPUT.MAX_SIZE_TEST:
        scale = cfg.INPUT.MAX_SIZE_TEST / max(h, w)
    rh, rw = int(h * scale + 0.5), int(w * scale + 0.5)
    nh, nw = (rh + 31) // 32 * 32, (rw + 31) // 32 * 32
    clip = np.empty((t, nh, nw, 3), np.float32)
    clip[:] = np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32)
    for fi in range(t):
        img = read_image({"file_name": rec["file_names"][fi]})
        if img is None:
            return None
        clip[fi, :rh, :rw] = _resize_image(img[..., ::-1], rh, rw)
    return {"rec": rec, "t": t, "rh": rh, "rw": rw, "clip": clip}


@torch.inference_mode()
def inference_on_video_dataset(cfg, model: torch.nn.Module, records: List[dict],
                               max_videos: Optional[int] = None,
                               max_frames: Optional[int] = None) -> Dict:
    """Tube AP over YTVIS-style records, each clip whole in one forward on
    the model's device (reference video_maskformer_model.py:255-287).
    `max_videos` caps the records, so an unreadable one shrinks the evaluated
    set, as in the JAX package; `max_frames` cuts long clips (None: no cut).
    Across data-parallel ranks each scores its share of the clips and every
    rank returns the merged results. The model is put in `.eval()` mode
    (`Trainer.test` restores its own)."""
    model.eval()
    evaluator = YTVISEvaluator(records)
    num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    device = next(model.parameters()).device

    def process(item: dict) -> None:
        rec = item["rec"]
        out = model(torch.from_numpy(item["clip"])[None].to(device))
        scores, classes, tubes = inference_video(
            out["pred_logits"][0], out["pred_masks"][0], (item["rh"], item["rw"]),
            rec["height"], rec["width"], num_classes)
        evaluator.process(rec["video_id"], scores, classes, list(tubes))

    n = sharded_eval_loop(records, evaluator, lambda rec: prep_clip(cfg, rec, max_frames),
                          process, max_records=max_videos)
    results = evaluator.evaluate()
    logger.info("evaluated %d videos: %s", n, results)
    return results
