"""The DN (mask-piloted) training path of the port's model against the JAX
package's: the outputs of the whole model with DN_MODE points, without noise
(NUM_DN 1 and 5, TPU.DN_MAX_GT), with the JAX side's recorded label and point
noise, and under the NUM_DN >= 100 budget rule
(tests/test_torch_dn_decoder.py:run_pair; its tolerances: logits 1e-3, mask
logits 1e-2). Six tests at most a file: the Tier-1 run queues such files
behind its longest one (ROADMAP.md, "Tier-1's clock").
"""

import pytest
import torch

from mp_former_tpu.engine.train_step import compute_dn_groups as jax_compute_dn_groups

from mp_former_tpu_torch.engine.train_step import compute_dn_groups

from test_torch_dn_decoder import assert_outputs_match, make_targets, run_pair, seeded_base

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def base():
    return seeded_base()


@pytest.mark.parametrize("num_dn,dn_max_gt,queries", [(1, 0, 6), (5, 4, 20)])
def test_dn_outputs_match_jax_without_noise(monkeypatch, base, num_dn, dn_max_gt, queries):
    """NUM_DN 1 (the released recipe) and 5; TPU.DN_MAX_GT 4 cuts the block
    from 6 slots a group to 4. Slots without an instance are in the block."""
    got, want = run_pair(monkeypatch, base, ["MODEL.DN.NUM_DN", str(num_dn), "MODEL.DN.NOISE_SCALE",
                                       "0.0", "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.0",
                                       "TPU.DN_MAX_GT", str(dn_max_gt)])
    assert_outputs_match(got, want, queries)
    assert got["pred_logits"].shape[1] == 8


def test_dn_outputs_match_jax_with_recorded_label_and_point_noise(monkeypatch, base):
    """Class-flip noise 0.5 and point noise 0.4 on the attention masks of two
    groups, refreshed in every layer (ALL_LY_DN): the JAX side's draws."""
    got, want = run_pair(monkeypatch, base, ["MODEL.DN.NUM_DN", "2", "MODEL.DN.NOISE_SCALE", "0.4",
                                       "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.5",
                                       "TPU.DN_MAX_GT", "0"])
    assert_outputs_match(got, want, 12)


def test_dn_budget_rule_with_compute_dn_groups(monkeypatch, base):
    """NUM_DN >= 100 is a budget of DN queries: groups = budget // batch max,
    the block cut to groups * batch_max (here 33 * 3 = 99 queries)."""
    _, tt = make_targets()
    groups = compute_dn_groups(100, tt.valid)
    assert groups == jax_compute_dn_groups(100, tt.valid.numpy()) == (33, 3)
    got, want = run_pair(monkeypatch, base, ["MODEL.DN.NUM_DN", "100", "MODEL.DN.NOISE_SCALE", "0.0",
                                       "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.0",
                                       "TPU.DN_MAX_GT", "4"], dn_groups=groups)
    assert_outputs_match(got, want, 99)
    assert got["dn_out"]["dn_args"] == {"max_num": 3, "pad_size": 99, "scalar": 33}
