"""`python -m mp_former_tpu_torch.eval_batch`, the port's twin of the root
`eval_batch.py`: the commands it runs against the root script's for the
same directory, and a real run on the CPU over two checkpoints of a small
model and a broken one, each scored as an in-process `run_evaluation` of the
same weights scores it.
"""

import json
import os
import runpy
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from mp_former_tpu_torch import eval_batch

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
NAMES = ["b.pth", "a.pkl", "notes.txt", "c.pth", "model.pth.bak"]


def test_the_commands_are_the_root_scripts(tmp_path):
    """For the same directory and arguments the port runs the root script's
    commands: the same `.pth` and `.pkl` files in the same sorted order, the
    same config and options, with `train_net.py` mapped to the port's entry
    point; the `=== evaluating <path> ===` lines are the same."""
    for name in NAMES:
        (tmp_path / name).write_bytes(b"")
    argv = [str(tmp_path), "--config-file", "some.yaml", "MODEL.DEVICE", "cpu",
            "--max-eval-images", "2"]

    def record(into):
        def run(cmd, check=False):
            assert check is False
            into.append(cmd)
        return run

    want, got = [], []
    with mock.patch.object(sys, "argv", ["eval_batch.py", *argv]), \
            mock.patch.object(subprocess, "run", record(want)), \
            mock.patch("builtins.print") as jax_print:
        runpy.run_path(os.path.join(REPO, "eval_batch.py"), run_name="__main__")
    with mock.patch.object(subprocess, "run", record(got)), \
            mock.patch("builtins.print") as port_print:
        eval_batch.main(argv)
    assert [c.args for c in port_print.call_args_list] == [c.args for c in
                                                           jax_print.call_args_list]
    assert [os.path.basename(c[c.index("MODEL.WEIGHTS") + 1]) for c in got] == ["a.pkl", "b.pth",
                                                                              "c.pth"]
    assert len(got) == len(want)
    for port, root in zip(got, want):
        assert root[:2] == [sys.executable, "train_net.py"]
        assert port[:3] == [sys.executable, "-m", "mp_former_tpu_torch.train_net"]
        assert port[3:] == root[2:]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The synthetic COCO val split of `tools/make_synthetic_coco_torch.py`
    (3 images) as $DETECTRON2_DATASETS's `coco_2017_val`; two checkpoints of
    the small released model (the seeded init, then its weights perturbed)
    and a broken one between them, a `.txt` beside them; the output of
    `python -m mp_former_tpu_torch.eval_batch` over the directory."""
    from test_torch_slice import SMALL
    from tools.make_synthetic_coco_torch import write_dataset

    from mp_former_tpu_torch.config import build_cfg
    from mp_former_tpu_torch.models import build_model

    root = tmp_path_factory.mktemp("eval_batch")
    write_dataset(str(root / "data"), images=3, size=64, classes=4, split="val2017", seed=1)
    ckpts = root / "ckpts"
    ckpts.mkdir()
    opts = SMALL + ["MODEL.DEVICE", "cpu", "DATASETS.TEST", "('coco_2017_val',)"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(build_cfg(eval_batch.DEFAULT_CONFIG, opts))
    weights = {}
    weights["a_init.pth"] = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    weights["c_perturbed.pth"] = {k: v + 0.05 * torch.randn(v.shape, generator=g)
                                  if v.is_floating_point() else v
                                  for k, v in model.state_dict().items()}
    for name, sd in weights.items():
        torch.save({"model": sd}, ckpts / name)
    (ckpts / "b_broken.pth").write_bytes(b"not a checkpoint")
    (ckpts / "notes.txt").write_text("skipped")
    env = dict(os.environ, DETECTRON2_DATASETS=str(root / "data"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "mp_former_tpu_torch.eval_batch", str(ckpts),
                          "--config-file", eval_batch.DEFAULT_CONFIG, *opts],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    return dict(out=out, root=root, ckpts=ckpts, weights=weights, opts=opts)


def _scored(stdout: str):
    """(checkpoint, printed results or None) in the order the run printed them."""
    runs = []
    for line in stdout.splitlines():
        if line.startswith("=== evaluating "):
            runs.append([line[len("=== evaluating "):-len(" ===")], None])
        elif line.startswith("{") and runs:
            runs[-1][1] = eval(line, {"nan": float("nan"), "np": np})
    return runs


def test_each_checkpoint_scores_as_in_process(run):
    """Each good checkpoint's printed results equal an in-process
    `run_evaluation` of the same weights on the same split, key for key; the
    checkpoints run in sorted order and the `.txt` is skipped."""
    from mp_former_tpu_torch.config import build_cfg
    from mp_former_tpu_torch.data.datasets.coco import register_coco_instances
    from mp_former_tpu_torch.engine.convert import load_weights
    from mp_former_tpu_torch.engine.eval_loop import run_evaluation
    from mp_former_tpu_torch.models import build_model

    assert run["out"].returncode == 0, run["out"].stderr[-3000:]
    runs = _scored(run["out"].stdout)
    assert [os.path.basename(p) for p, _ in runs] == ["a_init.pth", "b_broken.pth",
                                                      "c_perturbed.pth"]
    data = run["root"] / "data" / "coco"
    name = "eval_batch_test_val"
    register_coco_instances(name, str(data / "annotations" / "instances_val2017.json"),
                            str(data / "val2017"))
    cfg = build_cfg(eval_batch.DEFAULT_CONFIG, run["opts"] + ["DATASETS.TEST", f"('{name}',)"])
    for path, printed in runs:
        if "broken" in path:
            continue
        model = build_model(cfg)
        load_weights(model, run["weights"][os.path.basename(path)])
        want = run_evaluation(cfg, model, name)
        assert printed is not None and set(printed) == set(want) == {"segm"}
        assert json.dumps(printed) == json.dumps(want)
        assert np.isfinite(want["segm"]["AP"])


def test_a_broken_checkpoint_leaves_the_loop_going(run):
    """The broken checkpoint's evaluation fails in its own process (its
    error on stderr, no results), and the next checkpoint is still scored."""
    runs = dict(_scored(run["out"].stdout))
    broken = str(run["ckpts"] / "b_broken.pth")
    assert runs[broken] is None
    assert runs[str(run["ckpts"] / "c_perturbed.pth")] is not None
    assert "Traceback" in run["out"].stderr
