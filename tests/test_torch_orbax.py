"""`tools/convert_orbax_torch.py` and `engine/convert.py`'s training-state
conversions: a JAX `TrainState` after two AdamW updates, saved by Orbax as
the JAX trainer saves it, becomes the port's checkpoint; the port's
`Trainer` resumes it and takes a third update equal to the JAX one; the
port's checkpoint then goes back to Orbax, and the JAX trainer's restore
gives the JAX state after three updates. The released recipe at small
widths, clipping off; the gradients are seeded random trees, zero on the
FrozenBN statistics (params in JAX whose updates are zeroed, buffers in the
port). SGD's momentum (`optax.trace`) crosses both ways in memory.

Tolerances (float32 on both sides): parameters within 1e-3 LR of the JAX
ones after the update; the moments 1e-5 relative to each leaf's largest
entry; the counts, the step and the LR exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

from mp_former_tpu.engine.optimizer import build_optimizer as jax_build_optimizer
from mp_former_tpu_torch.engine.convert import (named_gradients_from_jax,
                                                state_dict_from_jax_params)
from mp_former_tpu_torch.engine.trainer import Trainer

from test_torch_slice import CONFIG, SMALL
from tools import convert_orbax_torch as tool

torch.set_num_threads(2)

LR = 1e-3
# the small widths with one encoder and two decoder layers: fewer leaves to convert
OPTS = SMALL + ["MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "1",
                "MODEL.MASK_FORMER.DEC_LAYERS", "2",
                "SOLVER.BASE_LR", str(LR), "SOLVER.CLIP_GRADIENTS.ENABLED", "False",
                "SOLVER.LR_SCHEDULER_NAME", "WarmupMultiStepLR", "SOLVER.STEPS", "(2,)",
                "SOLVER.WARMUP_ITERS", "0", "MODEL.WEIGHTS", ""]
SGD = ["SOLVER.OPTIMIZER", "SGD", "SOLVER.MOMENTUM", "0.9", "SOLVER.WEIGHT_DECAY", "0.0",
       "SOLVER.WEIGHT_DECAY_NORM", "0.0", "SOLVER.WEIGHT_DECAY_EMBED", "0.0"]


def _grads(params, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, p):
        frozen = any("frozen_bn" in str(getattr(k, "key", k)) for k in path)
        return np.zeros_like(p) if frozen else rng.normal(0, 1, p.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _save_orbax(state, root):
    mgr = ocp.CheckpointManager(os.path.abspath(os.path.join(root, "checkpoints")),
                                options=ocp.CheckpointManagerOptions(max_to_keep=3, create=True))
    mgr.save(int(state.step), args=ocp.args.StandardSave(jax.tree.map(np.asarray, state)))
    mgr.wait_until_finished()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    jcfg, tcfg = tool.build_cfgs(CONFIG, OPTS)
    torch.manual_seed(0)
    state = jax.tree.map(np.asarray, tool.jax_template(jcfg, tcfg))
    tx = jax_build_optimizer(jcfg, state.params)

    @jax.jit
    def update(grads, s):
        import optax

        updates, opt_state = tx.update(grads, s.opt_state, s.params)
        return s._replace(step=s.step + 1, params=optax.apply_updates(s.params, updates),
                          opt_state=opt_state)

    for seed in (1, 2):
        state = update(_grads(state.params, seed), state)
    _save_orbax(state, str(tmp / "jax"))
    # Orbax -> the port, which resumes and takes update 3
    pth = tool.main(["--config-file", CONFIG, "--orbax", str(tmp / "jax" / "checkpoints"),
                     "--output-dir", str(tmp / "port"), *OPTS])
    g3 = _grads(state.params, 3)
    state3 = jax.tree.map(np.asarray, update(g3, state))
    tcfg = tool.build_cfgs(CONFIG, OPTS + ["OUTPUT_DIR", str(tmp / "port")])[1]
    trainer = Trainer(tcfg, iter(()), device="cpu")
    start = trainer.resume_or_load(resume=True)
    named = named_gradients_from_jax(g3, trainer.model)
    for n, p in trainer.model.named_parameters():
        p.grad = named[n].clone()
    lr_before = [g["lr"] for g in trainer.optimizer.param_groups]
    trainer.optimizer.step()
    trainer.scheduler.step()
    # the port -> Orbax, restored as the JAX trainer restores
    back = tool.main(["--config-file", CONFIG, "--pth", trainer.save(3),
                      "--output-dir", str(tmp / "back"), *OPTS])
    mgr = ocp.CheckpointManager(os.path.abspath(tmp / "back" / "checkpoints"))
    restored = mgr.restore(mgr.latest_step(),
                           args=ocp.args.StandardRestore(jax.tree.map(np.asarray, state3)))
    return dict(pth=pth, back=back, start=start, trainer=trainer, state3=state3,
                restored=restored, lr_before=lr_before)


def test_the_port_resumes_a_jax_run_and_steps_as_jax(runs):
    trainer, want = runs["trainer"], state_dict_from_jax_params(runs["state3"].params)
    assert os.path.basename(runs["pth"]) == "model_0000002.pth" and runs["start"] == 2
    # the LR of update 3 is the schedule's at count 2 (SOLVER.STEPS (2,): one drop)
    assert all(abs(lr - m * LR * 0.1) < 1e-12 for lr, m in
               zip(runs["lr_before"], [g["initial_lr"] for g in trainer.optimizer.param_groups]))
    assert trainer.scheduler.last_epoch == 3
    assert len(want) == len(trainer.model.state_dict()) > 100
    for name, v in trainer.model.state_dict().items():
        assert (v - want[name]).abs().max().item() <= 1e-3 * LR, name


def test_the_jax_trainer_restores_the_ports_state(runs):
    got, want = runs["restored"], runs["state3"]
    assert runs["back"].endswith(os.path.join("checkpoints", "3"))
    assert int(got.step) == int(want.step) == 3
    params = jax.tree_util.tree_leaves_with_path(want.params)
    for (path, w), g in zip(params, jax.tree_util.tree_leaves(got.params)):
        assert np.abs(g - w).max() <= 1e-3 * LR, path
    assert "ScaleByAdamState" in str(jax.tree_util.tree_structure(got.opt_state))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want.opt_state),
                            jax.tree_util.tree_leaves(got.opt_state)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if np.issubdtype(w.dtype, np.integer):  # the counts
            assert np.array_equal(g, w), path
        else:
            scale = max(np.abs(w).max(), 1e-30)
            assert np.abs(g - w).max() <= 1e-5 * scale, path


def test_sgd_momentum_crosses_both_ways():
    """SGD's `optax.trace` is each parameter's `momentum_buffer`, and the
    port's state goes back to the same JAX tree; the schedule's count is the
    scheduler's `last_epoch`."""
    from mp_former_tpu_torch.engine.convert import (torch_state_from_jax_train_state,
                                                    torch_state_to_jax_train_state)

    jcfg, tcfg = tool.build_cfgs(CONFIG, OPTS + SGD)
    state = jax.tree.map(np.asarray, tool.jax_template(jcfg, tcfg))
    trace, schedule = state.opt_state[0], state.opt_state[-3]
    assert type(trace).__name__ == "TraceState" and type(schedule).__name__ == \
        "ScaleByScheduleState"
    opt_state = list(state.opt_state)
    opt_state[0] = trace._replace(trace=_grads(state.params, 4))
    opt_state[-3] = schedule._replace(count=np.asarray(5, np.int32))
    state = state._replace(step=np.asarray(5, np.int32), opt_state=tuple(opt_state))
    port = torch_state_from_jax_train_state(state, tcfg)
    want = state_dict_from_jax_params(opt_state[0].trace)
    names = {i: n for g in port["optimizer"]["param_groups"] for n, i in zip(g["names"],
                                                                            g["params"])}
    assert len(names) > 100 and port["scheduler"]["last_epoch"] == 5 == port["iteration"]
    for i, v in port["optimizer"]["state"].items():
        torch.testing.assert_close(v["momentum_buffer"], want[names[i]], rtol=0, atol=0)
    back = torch_state_to_jax_train_state(port, state)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(state),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(g, w), path
