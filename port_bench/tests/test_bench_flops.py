"""The benchmark's frozen FLOP count, read on its own reference, equals the
port's count (`mp_former_tpu_torch/utils/flops.py`) on the port's model, by
family, for the released recipe's forward and training forward and
backward at a small size, on the CPU."""

import torch

from port_bench import common, flops, spec


def _pair():
    cell = spec.Cell("r50_mp_train_b16_1024", 7, 1.0, False, 0.0, device="cpu")
    cfg = cell.program_cfg()
    from mp_former_tpu_torch.utils import flops as port_flops

    port = common.program_model(cell, cfg, torch.device("cpu"))
    ref = common.reference_model(cell, torch.device("cpu"))
    return cell, port, ref, port_flops


def test_forward_counts_equal_by_family():
    cell, port, ref, port_flops = _pair()
    images = torch.randint(0, 255, (1, 128, 160, 3)).float()
    with torch.no_grad():
        with port_flops.FlopCount() as a:
            port(images)
        with flops.FlopCount() as b:
            ref(images)
    got, want = b.by_family(), a.by_family()
    assert got == want
    assert got["K1"] > 0 and got["K3"] > 0 and got["convolution"] > 0


def _step_count(model, counter, images):
    model.train()
    with counter() as c:
        out = model(images)
        (out["pred_masks"].float().mean() + out["pred_logits"].float().mean()).backward()
    model.zero_grad(set_to_none=True)
    return c.by_family()


def test_forward_and_backward_counts_equal_by_family():
    """Without the encoder's recompute, which the port's count includes."""
    cell, port, ref, port_flops = _pair()
    images = torch.randint(0, 255, (1, 64, 64, 3)).float()
    for model, counter in ((port, port_flops.FlopCount), (ref, flops.FlopCount)):
        model.sem_seg_head.pixel_decoder.transformer.remat = False
        model.train()
        with counter() as c:
            out = model(images)
            (out["pred_masks"].float().mean() + out["pred_logits"].float().mean()).backward()
        model.zero_grad(set_to_none=True)
        if model is port:
            want = c.by_family()
        else:
            got = c.by_family()
    assert got == want
    assert got["K1 backward"] > 0 and got["K3 backward"] > 0


def test_bound_is_the_larger_of_bytes_and_operations():
    assert flops.bound_s(3.35e12, 0.0, "float32") == 1.0
    assert flops.bound_s(0.0, 495e12, "tf32") == 1.0
    assert flops.bound_s(3.35e12, 2 * 67e12, "float32") == 2.0


def test_count_leaves_the_encoder_recompute_out():
    cell, port, ref, port_flops = _pair()
    images = torch.randint(0, 255, (1, 64, 64, 3)).float()
    encoder = ref.sem_seg_head.pixel_decoder.transformer
    assert encoder.remat
    with_remat = _step_count(ref, flops.FlopCount, images)
    encoder.remat = False
    assert _step_count(ref, flops.FlopCount, images) == with_remat
