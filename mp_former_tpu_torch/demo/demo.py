"""Image demo (reference demo/demo.py; the port's twin of the JAX package's
`demo/demo.py`): a config and weights run on images, and their instance and
semantic overlays are written.

    python -m mp_former_tpu_torch.demo.demo --config-file <yaml> \\
        --input img1.npy img2.jpg --output out_dir [--confidence-threshold 0.5] \\
        [KEY VALUE ...]

Inputs: `.npy` images ((H, W, 3) uint8 BGR, as `engine/eval_loop.py:
read_image` takes them), and any image cv2 decodes where cv2 is installed;
`--video-input` takes what `demo_video/demo.py:read_frames` reads. It runs
on MODEL.DEVICE (the card unless `cpu`). The overlays are
`overlay.py`'s: the JAX demo's bit for bit where cv2 is installed, else
without the labels and written as PNG.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .overlay import overlay_semantic, write_image


def output_stem(output: str, path: str):
    """(stem, extension) of an input's outputs under `output`: the input's own
    extension where cv2 writes it (the JAX demo's names), `.png` for a `.npy`
    input."""
    stem, ext = os.path.splitext(os.path.join(output, os.path.basename(path)))
    return stem, ".png" if ext == ".npy" else ext


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="MP-Former image demo, the PyTorch port")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", nargs="+", help="image paths (.npy, or what cv2 reads)")
    p.add_argument("--video-input", help="frames: a (T, H, W, 3) .npy, a directory of "
                                         "frames, or a video file cv2 reads")
    p.add_argument("--webcam", action="store_true", help="camera 0 (needs cv2)")
    p.add_argument("--output", default="demo_out")
    p.add_argument("--confidence-threshold", type=float, default=0.5)
    p.add_argument("--max-frames", type=int, default=100)
    p.add_argument("--parallel", action="store_true",
                   help="overlap host work with the device's (reference AsyncPredictor)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)
    if not (args.input or args.video_input or args.webcam):
        p.error("one of --input / --video-input / --webcam is required")

    from ..config import build_cfg
    from ..demo_video.demo import read_frames
    from ..engine.eval_loop import read_image
    from .predictor import AsyncPredictor, VisualizationDemo

    cfg = build_cfg(args.config_file, args.opts or [])
    os.makedirs(args.output, exist_ok=True)
    demo = VisualizationDemo(cfg, parallel=args.parallel)
    demo.threshold = args.confidence_threshold
    try:
        if args.input:
            for path in args.input:
                img = read_image({"file_name": path})
                if img is None:
                    print(f"could not read {path}")
                    continue
                predictions, vis = demo.run_on_image(img)
                stem, ext = output_stem(args.output, path)
                if "instances" in predictions:
                    write_image(f"{stem}_instance{ext}", vis)
                if "sem_seg" in predictions:
                    write_image(f"{stem}_semantic{ext}",
                                overlay_semantic(img, predictions["sem_seg"]))
                print(f"wrote visualizations for {path}")
        else:
            frames = read_frames(0 if args.webcam else args.video_input, args.max_frames)
            for i, (_, vis) in enumerate(demo.run_on_video(frames, max_frames=args.max_frames)):
                write_image(os.path.join(args.output, f"frame_{i:05d}.jpg"), vis)
                print(f"wrote frame {i}")
    finally:
        if isinstance(demo.predictor, AsyncPredictor):
            demo.predictor.shutdown()


if __name__ == "__main__":
    main()
