"""One video training step in the port against the JAX package at a small
size, and the video entry point training, resuming and scoring a synthetic
dataset (tests/test_torch_video_train.py holds the mappers, the matcher and
losses, and the slot cut). Six tests at most a file: the Tier-1 run queues
such files behind its longest one (ROADMAP.md, "Tier-1's clock"). Tolerances are those of `tests/test_torch_train_step.py`.
"""

import copy
import json
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mp_former_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from mp_former_tpu.models.matcher import _lsa_host
from mp_former_tpu.video import VideoTargets as JVideoTargets
from mp_former_tpu.video import criterion as jax_vcrit

from mp_former_tpu_torch.data.catalog import DatasetCatalog
from mp_former_tpu_torch.engine.convert import named_gradients_from_jax
from mp_former_tpu_torch.engine.optimizer import build_gradient_clipper, build_optimizer
from mp_former_tpu_torch.engine.train_step import train_step
from mp_former_tpu_torch.models import criterion as tcrit_module
from mp_former_tpu_torch.structures import Batch, VideoTargets
from mp_former_tpu_torch.video import ytvis
from mp_former_tpu_torch.video.criterion import build_video_criterion

from test_torch_train_step import LR, check_parameters
from test_torch_video import SMALL, build_video_pair
from test_torch_video_train import R50, TRAIN_SIZES
from tools.make_synthetic_ytvis_torch import write_dataset

torch.set_num_threads(2)


STEP = SMALL + ["MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "SOLVER.BASE_LR", str(LR),
                "SOLVER.CLIP_GRADIENTS.ENABLED", "False", "SOLVER.LR_SCHEDULER_NAME",
                "WarmupMultiStepLR", "MODEL.BACKBONE.FREEZE_AT", "2"]


def test_video_step_matches_jax(monkeypatch):
    """One training step at T = 2 in both packages, on two clips with a slot
    left invalid between valid ones: the loss dict (the JAX package's own
    assignments, the loss points recorded in the JAX criterion and replayed),
    every gradient, and the parameters after AdamW, at
    `tests/test_torch_train_step.py`'s tolerances. The encoder's sampling
    offsets keep the reference init (weights 0, the compass rose's bias), so
    every sampling location is a pixel centre of its own level, where the
    derivative in the location jumps (levels 12, 6 and 3 wide)."""
    jcfg, jmodel, params, tcfg, tmodel = build_video_pair(frames=2, seed=2, overrides=STEP,
                                                          at_init=("sampling_offsets",))
    rng = np.random.RandomState(6)
    clips = rng.randint(0, 256, (2, 2, 64, 96, 3)).astype(np.uint8)
    valid = np.asarray([[1, 0, 1, 0], [1, 1, 0, 0]], bool)
    masks = np.zeros((2, 4, 2, 64, 96), bool)
    for i, j in zip(*np.nonzero(valid)):
        y, x = rng.randint(0, 32), rng.randint(0, 48)
        masks[i, j, :, y:y + 24, x:x + 40] = True
        masks[i, j, 1] = np.roll(masks[i, j, 1], 4, axis=1)
    labels = rng.randint(0, 40, (2, 4))
    jt = JVideoTargets(jnp.asarray(labels, jnp.int32), jnp.asarray(masks), jnp.asarray(valid))
    tt = VideoTargets(torch.from_numpy(labels), torch.from_numpy(masks), torch.from_numpy(valid))
    jcrit = jax_vcrit.build_video_criterion(jcfg)
    jcrit.point_matmul = False
    rng_loss = jax.random.PRNGKey(3)
    num_masks = jnp.maximum(jt.valid.sum().astype(jnp.float32), 1.0)
    images = jnp.asarray(clips)

    @jax.jit
    def cost_pass(p):
        out = jmodel.apply({"params": p}, images, None, train=True)
        return jcrit.layer_costs(out, jt, rng_loss)[0]

    costs = np.asarray(cost_pass(params))
    l, b, q, n = costs.shape
    assignments = _lsa_host(costs.reshape(l * b, q, n)).reshape(l, b, n)

    recorded, real_uniform = [], jax.random.uniform

    def loss_fn(p):
        out = jmodel.apply({"params": p}, images, None, train=True)
        monkeypatch.setattr(jax.random, "uniform", recording)
        losses = jcrit(out, jt, rng_loss, num_masks=num_masks,
                       assignments=jnp.asarray(assignments))
        monkeypatch.setattr(jax.random, "uniform", real_uniform)
        return jcrit.weighted_total(losses), (losses, list(recorded))

    def recording(*args, **kwargs):
        recorded.append(real_uniform(*args, **kwargs))
        return recorded[-1]

    (jtotal, (jlosses, draws)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    draws = [np.asarray(d) for d in draws]
    assert len(draws) == 2
    tx = jax_build_optimizer(jcfg, params)
    jnew = jax.jit(lambda g, p: jax.tree.map(
        lambda a, u: a + u, p, tx.update(g, tx.init(p), p)[0]))(jgrads, params)

    def replayed_uniform(shape, generator, device):
        rec = draws.pop(0)
        return torch.from_numpy(rec[tuple(slice(0, s) for s in shape)].copy())

    monkeypatch.setattr(tcrit_module, "uniform", replayed_uniform)
    model = copy.deepcopy(tmodel)
    optimizer, scheduler = build_optimizer(tcfg, model)
    criterion = build_video_criterion(tcfg)
    criterion.assign = lambda c: torch.from_numpy(assignments.astype(np.int64))
    metrics = train_step(model, criterion, optimizer, scheduler,
                         Batch(torch.from_numpy(clips), tt), torch.Generator().manual_seed(0),
                         clip_gradients=build_gradient_clipper(tcfg))
    assert not draws, "the port drew fewer times than the JAX criterion"

    want = {k: float(v) for k, v in jlosses.items()}
    assert set(metrics) == set(want) | {"total_loss"} and len(want) == 6 * 4
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].item(), float(jtotal), rtol=1e-4)

    jgrads = jax.tree.map(np.asarray, jgrads)
    grads = named_gradients_from_jax(jgrads, model)
    largest = max(g.abs().max().item() for g in grads.values())
    names = []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(("backbone.stem", "backbone.res2")), name
            continue
        scale = max(grads[name].abs().max().item(), 1e-4 * largest)
        assert (p.grad - grads[name]).abs().max().item() <= 1e-3 * scale, name
        names.append(name)
    for part in ("backbone.res5", "encoder.layers.0.self_attn.sampling_offsets",
                 "multihead_attn.in_proj_weight", "query_embed", "query_feat", "mask_embed"):
        assert any(part in x for x in names), part
    check_parameters({"model": model, "start": tmodel, "jgrads": jgrads,
                      "jnew": jax.tree.map(np.asarray, jnew)})


def test_video_entry_point_trains_resumes_and_scores(tmp_path, monkeypatch):
    """`python -m mp_former_tpu_torch.train_net_video` without --eval-only
    on a synthetic split of `.npy` frames: 2 steps with `Trainer.test`
    scoring tube AP after the second, `metrics.json` and a checkpoint; then
    `--resume` continues to step 3 from the checkpoint, and `--eval-only
    --resume` scores the last checkpoint."""
    from mp_former_tpu_torch import train_net_video
    from mp_former_tpu_torch.engine.trainer import Trainer

    root = tmp_path / "data"
    write_dataset(str(root), videos=3, frames=(2, 3, 1), height=64, width=96, classes=40,
                  split="train", seed=0)
    write_dataset(str(root), videos=2, frames=(2, 3), height=64, width=96, classes=40,
                  split="valid", seed=1)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    fresh = type(DatasetCatalog)()
    monkeypatch.setattr(ytvis, "DatasetCatalog", fresh)
    monkeypatch.setattr("mp_former_tpu_torch.data.catalog.DatasetCatalog", fresh)
    scored, test = [], Trainer.test

    def recording_test(self, *args, **kwargs):
        scored.append(test(self, *args, **kwargs))
        return scored[-1]

    monkeypatch.setattr(Trainer, "test", recording_test)
    out = str(tmp_path / "out")
    parse = train_net_video.default_argument_parser().parse_args
    flags = ["--config-file", R50]
    keys = SMALL + TRAIN_SIZES + [
        "MODEL.MASK_FORMER.TRAIN_NUM_POINTS", "64", "TPU.MAX_INSTANCES", "10",
        "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "1", "TEST.EVAL_PERIOD", "2",
        "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out]
    assert train_net_video.main(parse(flags + keys + ["SOLVER.MAX_ITER", "2"])) is None
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["iteration"] for x in lines] == [0, 1]
    assert all(np.isfinite(v) for x in lines for v in x.values())
    assert len([k for k in lines[-1] if k.startswith("loss_")]) == 6 * 4
    ckpt = os.path.join(out, "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["last_checkpoint", "model_0000002.pth"]
    assert len(scored) == 1 and set(scored[0]["segm"]) == {"AP", "AP50", "AP75", "APs", "APm",
                                                           "APl"}
    assert np.isfinite(scored[0]["segm"]["AP"])

    train_net_video.main(parse(flags + ["--resume"] + keys + ["SOLVER.MAX_ITER", "3"]))
    with open(os.path.join(out, "metrics.json")) as f:
        assert [json.loads(x)["iteration"] for x in f] == [0, 1, 2]
    assert "model_0000003.pth" in os.listdir(ckpt)
    results = train_net_video.main(parse(flags + ["--eval-only", "--resume"] + keys))
    assert np.isfinite(results["segm"]["AP"])
    assert fresh.list() == ["ytvis_2019_train", "ytvis_2019_val", "ytvis_2021_train",
                            "ytvis_2021_val"]
