"""The port's twins of the two evaluation tools that import the JAX package
(ROADMAP A22): `tools/evaluate_coco_boundary_ap_torch.py` against
`tools/evaluate_coco_boundary_ap.py` (the boundary regions bit for bit, its
numpy erosion against cv2's; every summary key equal) and
`tools/evaluate_pq_for_semantic_segmentation_torch.py` against
`tools/evaluate_pq_for_semantic_segmentation.py` (the JAX tool on PNG maps,
the port's on their `.npy` twins: the same PQ, SQ and RQ)."""

import importlib.util
import json
import os
import sys
from unittest import mock

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rect(x0, y0, x1, y1):
    return [float(x0), float(y0), float(x1), float(y0), float(x1), float(y1), float(x0),
            float(y1)]


def test_boundary_ap_matches_jax_tool(tmp_path, capsys):
    jax_tool = _load("jax_boundary_ap", "tools/evaluate_coco_boundary_ap.py")
    port_tool = _load("port_boundary_ap", "tools/evaluate_coco_boundary_ap_torch.py")
    from mp_former_tpu_torch.evaluation.coco_eval import rle_to_mask

    rng = np.random.RandomState(0)
    images, anns, dts = [], [], []
    for i in range(4):
        h, w = int(rng.randint(40, 90)), int(rng.randint(40, 90))
        images.append({"id": i, "height": h, "width": w})
        for _ in range(rng.randint(1, 4)):
            x0, y0 = rng.randint(0, w - 12), rng.randint(0, h - 12)
            x1, y1 = x0 + rng.randint(6, w - x0), y0 + rng.randint(6, h - y0)
            cat = int(rng.randint(1, 4))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat,
                         "segmentation": [_rect(x0, y0, x1, y1)], "iscrowd": 0})
            dx, dy = rng.randint(-3, 4, 2)
            dts.append({"image_id": i, "category_id": cat, "score": float(rng.rand()),
                        "segmentation": [_rect(max(x0 + dx, 0), max(y0 + dy, 0), x1, y1)]})
        m = rng.rand(h, w) < 0.3  # an uncompressed RLE detection of a random mask
        flat = m.T.reshape(-1).astype(np.uint8)
        change = np.nonzero(np.diff(flat))[0] + 1
        runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
        rle = {"size": [h, w], "counts": ([0] if flat[0] else []) + runs}
        np.testing.assert_array_equal(rle_to_mask(rle), m)
        dts.append({"image_id": i, "category_id": 1, "score": 0.5, "segmentation": rle})
        for d in (1, 2, 3):
            ref = np.pad(m.astype(np.uint8), 1)
            np.testing.assert_array_equal(
                port_tool.erode(ref, d), cv2.erode(ref, np.ones((3, 3), np.uint8),
                                                   iterations=d).astype(bool))
        np.testing.assert_array_equal(port_tool.mask_to_boundary(m), jax_tool.mask_to_boundary(m))
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c, "name": str(c)} for c in (1, 2, 3)]}
    gt_path, dt_path = tmp_path / "gt.json", tmp_path / "dt.json"
    gt_path.write_text(json.dumps(gt))
    dt_path.write_text(json.dumps(dts))
    with mock.patch.object(sys, "argv", ["tool", "--gt-json", str(gt_path),
                                         "--dt-json", str(dt_path)]):
        jax_tool.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_tool.main(["--gt-json", str(gt_path), "--dt-json", str(dt_path)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert 0 < got["boundary_AP"] < 100


def test_semantic_pq_matches_jax_tool(tmp_path, capsys):
    jax_tool = _load("jax_semantic_pq", "tools/evaluate_pq_for_semantic_segmentation.py")
    port_tool = _load("port_semantic_pq", "tools/evaluate_pq_for_semantic_segmentation_torch.py")
    rng = np.random.RandomState(1)
    dirs = {k: tmp_path / k for k in ("pred_png", "gt_png", "pred_npy", "gt_npy")}
    for d in dirs.values():
        d.mkdir()
    for i in range(3):
        gt = np.full((48, 64), 255, np.uint8)
        for c in rng.choice(5, 3, replace=False):
            y, x = rng.randint(0, 36, 2)
            gt[y:y + rng.randint(6, 20), x:x + rng.randint(6, 30)] = c
        pred = gt.copy()
        pred[rng.rand(48, 64) < 0.15] = rng.randint(0, 6)
        for kind, m in (("pred", pred), ("gt", gt)):
            cv2.imwrite(str(dirs[f"{kind}_png"] / f"{i}.png"), m)
            np.save(dirs[f"{kind}_npy"] / f"{i}.npy", m)
    with mock.patch.object(sys, "argv", ["tool", "--pred-dir", str(dirs["pred_png"]),
                                         "--gt-dir", str(dirs["gt_png"]), "--num-classes", "5"]):
        jax_tool.main()
    want = capsys.readouterr().out
    port_tool.main(["--pred-dir", str(dirs["pred_npy"]), "--gt-dir", str(dirs["gt_npy"]),
                    "--num-classes", "5"])
    got = capsys.readouterr().out
    assert got == want and got.startswith("evaluated 3 maps")
    n, res = port_tool.semantic_pq(str(dirs["pred_png"]), str(dirs["gt_png"]), 5)
    assert n == 3 and str(res) == got.splitlines()[1]
