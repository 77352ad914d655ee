"""Hosted-demo predictor (reference predict.py and cog.yaml; the port's twin
of the JAX package's `predict.py`): one image in, its instance, semantic and
panoptic drawings out, from one forward.

    python -m mp_former_tpu_torch.predict --image input.npy \\
        [--config-file <yaml>] [--weights ckpt.pth] [--output out_prefix] [KEY VALUE ...]

The image is a `.npy` ((H, W, 3) uint8 BGR) or anything cv2 decodes where
cv2 is installed; it runs on MODEL.DEVICE (the card unless `cpu`). Writes
`<output>_instance.png`, `<output>_semantic.png` and `<output>_panoptic.png`
(`demo/overlay.py`: the JAX package's pixels, with labels where cv2 is
installed).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np


class Predictor:
    """setup() / predict(), the reference's cog BasePredictor interface; the
    forward is `demo/predictor.py:Predictor.forward_raw`, which every demo
    pipeline shares."""

    def setup(self, config_file: str, weights: str = "", opts: Sequence[str] = ()) -> None:
        from .data.datasets.builtin_meta import coco_panoptic_is_thing
        from .config import build_cfg
        from .demo.predictor import Predictor as DemoPredictor

        self.cfg = build_cfg(config_file, list(opts) + (["MODEL.WEIGHTS", weights]
                                                        if weights else []))
        k = self.cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        is_thing = coco_panoptic_is_thing() if k == 133 else np.ones(k, bool)
        self._p = DemoPredictor(self.cfg, is_thing=is_thing)

    def predict(self, image_bgr: np.ndarray):
        """(logits (Q, K+1), mask logits (Q, h4, w4), resized (h, w))."""
        return self._p.forward_raw(image_bgr)

    def drawings(self, image_bgr: np.ndarray) -> dict:
        """{"instance", "semantic", "panoptic"} -> the image drawn with that
        task's prediction (`predict.py:66-86`), and "segments", the panoptic
        segments; one forward."""
        from .demo.overlay import overlay_instances, overlay_panoptic, overlay_semantic

        out = self._p.engine(image_bgr, tasks=("instance", "semantic", "panoptic"))
        inst = out["instances"]
        pan_map, segments = out["panoptic_seg"]
        return {"instance": overlay_instances(image_bgr, inst["scores"], inst["classes"],
                                              inst["masks"]),
                "semantic": overlay_semantic(image_bgr, out["sem_seg"]),
                "panoptic": overlay_panoptic(image_bgr, pan_map), "segments": segments}


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description="MP-Former predict, the PyTorch port")
    p.add_argument("--image", required=True)
    p.add_argument("--config-file",
                   default="configs/coco/panoptic-segmentation/maskformer2_R50_bs16_50ep.yaml")
    p.add_argument("--weights", default="")
    p.add_argument("--output", default="prediction")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    from .demo.overlay import write_image
    from .engine.eval_loop import read_image

    img = read_image({"file_name": args.image})
    if img is None:
        raise FileNotFoundError(f"could not read {args.image}")
    pred = Predictor()
    pred.setup(args.config_file, args.weights, args.opts or [])
    drawn = pred.drawings(img)
    written = [write_image(f"{args.output}_{task}.png", drawn[task])
               for task in ("instance", "semantic", "panoptic")]
    print(f"wrote {args.output}_{{instance,semantic,panoptic}}.png "
          f"({len(drawn['segments'])} panoptic segments)")
    return written


if __name__ == "__main__":
    main()
