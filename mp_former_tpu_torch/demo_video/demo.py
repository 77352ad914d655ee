"""Video demo (reference demo_video/demo.py; the port's twin of the JAX
package's `demo_video/demo.py`): video instance segmentation over one clip,
each frame drawn with its tracks in colours that stay with them.

    python -m mp_former_tpu_torch.demo_video.demo \\
        --config-file configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml \\
        --input clip.npy --output out_dir [--max-frames 8] [KEY VALUE ...]

`--input`: one (T, H, W, 3) uint8 BGR `.npy`, a directory of frames (`.npy`,
and `.jpg` / `.png` where cv2 is installed) or a video file cv2 reads. The
clip is resized as the JAX demo resizes it (`demo_video/demo.py:71-77`: the
short side to INPUT.MIN_SIZE_TEST, each side rounded up to a multiple of 32,
no cap), on the device without cv2, and runs in one forward of
`VideoMaskFormer` on MODEL.DEVICE (the card unless `cpu`: K1 6 and K3 9
launches a clip); the ten best (query, class) tubes are drawn by
`TrackVisualizer`.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.transforms import resize_uint8
from ..demo.overlay import write_image
from ..engine.eval_loop import read_image
from ..utils.interp import resize


def read_frames(path: Union[str, int], max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """BGR uint8 frames of `path`, at most `max_frames`: the frames of a
    (T, H, W, 3) `.npy`, the sorted `.npy` / `.jpg` / `.png` files of a
    directory, or a video (a file or a camera index) through cv2."""
    if isinstance(path, str) and path.endswith(".npy"):
        clip = np.load(path)
        if clip.dtype != np.uint8 or clip.ndim != 4 or clip.shape[3] != 3:
            raise ValueError(f"{path}: expected a (T, H, W, 3) uint8 BGR array, "
                             f"got {clip.dtype} {clip.shape}")
        yield from clip[:max_frames]
        return
    if isinstance(path, str) and os.path.isdir(path):
        files = sorted(f for f in os.listdir(path) if f.lower().endswith((".npy", ".jpg", ".png")))
        for f in files[:max_frames]:
            frame = read_image({"file_name": os.path.join(path, f)})
            if frame is not None:
                yield frame
        return
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading the video {path!r} needs cv2, which is not installed; "
                          "give a .npy clip or a directory of .npy frames instead") from e
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok or (max_frames and n >= max_frames):
            break
        yield frame
        n += 1
    cap.release()


def clip_size(cfg, h: int, w: int) -> Tuple[int, int]:
    """The canvas of a clip of (h, w) frames (`demo_video/demo.py:71-77`)."""
    scale = cfg.INPUT.MIN_SIZE_TEST / min(h, w)
    return (int(h * scale + 0.5) + 31) // 32 * 32, (int(w * scale + 0.5) + 31) // 32 * 32


def clip_tensor(cfg, frames: Sequence[np.ndarray], device) -> torch.Tensor:
    """BGR frames -> (1, T, H', W', 3) float32 RGB on `device`, each frame
    resized to `clip_size` (bilinear, half-pixel centres, uint8 rounding)."""
    nh, nw = clip_size(cfg, *frames[0].shape[:2])
    clip = torch.from_numpy(np.ascontiguousarray(np.stack(frames)[..., ::-1])).to(device)
    return torch.stack([resize_uint8(f, nh, nw) for f in clip])[None].float()


@torch.inference_mode()
def predict_clip(cfg, model: torch.nn.Module, frames: Sequence[np.ndarray], topk: int = 10):
    """One whole-clip forward -> the `topk` best (query, class) pairs
    (reference inference_video :255-287, as the JAX demo takes them):
    (scores (topk,) float32, classes (topk,) int64, tubes (topk, T, H, W)
    bool at the frames' size)."""
    h, w = frames[0].shape[:2]
    out = model(clip_tensor(cfg, frames, next(model.parameters()).device))
    logits = out["pred_logits"][0].float().cpu().numpy()
    e = np.exp(logits - logits.max(-1, keepdims=True))
    flat = (e / e.sum(-1, keepdims=True))[:, :-1].reshape(-1)
    k = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    top = np.argsort(-flat)[:topk]
    masks = out["pred_masks"][0][torch.from_numpy(top // k).to(out["pred_masks"].device)]
    tubes = resize(masks.float(), (h, w), "bilinear") > 0
    return flat[top], (top % k).astype(np.int64), tubes.cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description="MP-Former video demo, the PyTorch port")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="demo_video_out")
    p.add_argument("--confidence-threshold", type=float, default=0.5)
    p.add_argument("--max-frames", type=int, default=8)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    from ..data.catalog import MetadataCatalog
    from ..config import build_cfg, cfg_device
    from ..engine.predictor import load_model
    from .visualizer import TrackVisualizer

    cfg = build_cfg(args.config_file, (args.opts or [])
                    + ["INPUT.SAMPLING_FRAME_NUM", str(args.max_frames)], video=True)
    device = cfg_device(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # without MODEL.WEIGHTS: the reference init from seed 0
        model = load_model(cfg).to(device)
    os.makedirs(args.output, exist_ok=True)

    frames = list(read_frames(args.input, args.max_frames))
    if not frames:
        raise FileNotFoundError(f"no frames found in {args.input}")
    scores, classes, tubes = predict_clip(cfg, model, frames)
    thing_classes = (MetadataCatalog.get(cfg.DATASETS.TEST[0]).get("thing_classes")
                     if cfg.DATASETS.TEST else None)
    rendered = TrackVisualizer(thing_classes).draw_clip(
        frames, tubes, classes, scores, score_threshold=args.confidence_threshold)
    written = [write_image(os.path.join(args.output, f"frame_{t:04d}.jpg"), img)
               for t, img in enumerate(rendered)]
    print(f"wrote {len(written)} visualized frames -> {args.output}")
    return written


if __name__ == "__main__":
    main()
