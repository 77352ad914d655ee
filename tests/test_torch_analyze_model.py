"""`tools/analyze_model_torch.py`, the port's twin of `tools/analyze_model.py`:
its parameter totals against the JAX tool's tree for four recipes, its
FLOP count against an independent count of the JAX model's jaxpr, and the
tool itself run on the CPU.

The JAX total is the JAX tool's: the leaves of `jax.eval_shape` of the
model's init. The port's is its parameters plus its state dict's
floating-point buffers (FrozenBN's statistics are parameters in the JAX tree
and buffers in the port). Both
are exact integers: equal, no tolerance.

The JAX FLOP count walks `jax.make_jaxpr` of the JAX model's eval forward and
adds 2 * MACs of every `conv_general_dilated` and `dot_general`. Two parts
of the JAX model have no product in the port and are stood in by functions
without products before it is traced:
- K1's function (`mp_former_tpu/ops/ms_deform_attn.py:ms_deform_attn`), whose
  XLA form gathers through products; the port counts K1 by its formula;
- the resizes (`mp_former_tpu/utils/interp.py`), which the JAX package writes
  as products with interpolation matrices (a TPU design choice) and the port
  as `F.interpolate`.
K3's function stays in the JAX count: its einsums are the formula's
products, so the port's products plus K3 equal the JAX products exactly.
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys

from unittest import mock

import numpy as np
import pytest

from mp_former_tpu_torch.utils import flops

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RELEASED = "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"
# MaskFormer-v1: the v1 pixel decoder and decoder at the recipe's widths
V1 = ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME", "BasePixelDecoder",
      "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME", "StandardTransformerDecoder",
      "MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE", "res5"]
RECIPES = {
    "released": (RELEASED, []),
    "swin": ("configs/coco/instance-segmentation/swin/maskformer2_swin_tiny_bs16_50ep.yaml", []),
    "maskformer1": ("configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml", V1),
    "ytvis": ("configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml", []),
}
# the image side both packages are initialised at (the total does not depend on it)
SIZE = 64


def _tool():
    spec = importlib.util.spec_from_file_location(
        "analyze_model_torch", os.path.join(REPO, "tools", "analyze_model_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def jax_model(recipe: str):
    """The JAX model of a recipe and its parameter shapes, by eval_shape of
    its init as the JAX tool takes them (the shapes do not depend on the
    image size)."""
    import jax
    import jax.numpy as jnp

    import mp_former_tpu.video  # noqa: F401  (registers the JAX video model)
    from mp_former_tpu.config import (add_deeplab_config, add_maskformer2_config,
                                      add_maskformer2_video_config, get_cfg)
    from mp_former_tpu.models import build_model

    config, opts = RECIPES[recipe]
    video = recipe == "ytvis"
    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    if video:
        add_maskformer2_video_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, config))
    cfg.merge_from_list(list(opts))
    model = build_model(cfg)
    # a clip of 2 frames: the JAX video model does not trace a single frame
    img = jnp.zeros((1, 2, SIZE, SIZE, 3) if video else (1, SIZE, SIZE, 3), jnp.float32)
    return model, jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, img, None, train=False))


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_parameter_total_equals_the_jax_tree(recipe):
    """Parameters plus buffers of the port's model equal the JAX tool's
    total for the released R50 recipe, Swin-T, MaskFormer-v1 and the R50
    YouTube-VIS recipe."""
    import torch

    from mp_former_tpu_torch.models import build_model

    tool = _tool()
    config, opts = RECIPES[recipe]
    cfg = tool.load_cfg(os.path.join(REPO, config), opts + ["MODEL.DEVICE", "cpu"])
    with torch.device("meta"):  # shapes alone: the tool builds in test_the_tool_runs_on_the_cpu
        model = build_model(cfg)
    total, n_params, n_buffers = tool.param_count(model)
    import jax

    # the JAX tool's count: every leaf of the init
    leaves = jax.tree.leaves(jax_model(recipe)[1])
    assert total == sum(int(np.prod(leaf.shape)) for leaf in leaves)
    assert n_params == len(list(model.parameters())) and n_buffers <= len(list(model.buffers()))
    # structure: depth-2 sizes that add up to the total at depth 1
    rows = dict(tool.structure(model))
    assert sum(n for name, n in rows.items() if "." not in name) == total


def _jaxpr_flops(jaxpr, mult=1.0, acc=None) -> dict:
    """2 * MACs of the convolutions and products of a jaxpr and its
    sub-jaxprs (a scan's body times its length)."""
    import jax.extend as jex

    acc = acc if acc is not None else {"conv": 0.0, "dot": 0.0}
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "conv_general_dilated":
            rhs = e.invars[1].aval.shape
            spec = e.params["dimension_numbers"].rhs_spec
            per_out = rhs[spec[1]] * np.prod([rhs[d] for d in spec[2:]])
            acc["conv"] += mult * 2.0 * np.prod(e.outvars[0].aval.shape) * per_out
        elif name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            acc["dot"] += mult * 2.0 * np.prod(e.outvars[0].aval.shape) * np.prod(
                [lhs[d] for d in lc])
        inner = mult * (e.params["length"] if name == "scan" else 1)
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jex.core.ClosedJaxpr):
                    _jaxpr_flops(sub.jaxpr, inner, acc)
                elif isinstance(sub, jex.core.Jaxpr):
                    _jaxpr_flops(sub, inner, acc)
    return acc


def test_counts_equal_the_jaxpr_count():
    """The released recipe's eval forward at 256 px: convolution FLOPs equal
    the jaxpr's exactly (17.052 G); the port's products plus K3 equal the
    jaxpr's products exactly once K1 and the resizes are stood in; K1 and K3
    are their formulas over the 6 encoder layers and the 9 masked
    attentions."""
    import jax
    import jax.numpy as jnp

    import mp_former_tpu.models.pixel_decoder.msdeformattn as jax_pixel
    import mp_former_tpu.models.transformer_decoder.mask2former_decoder as jax_decoder
    import mp_former_tpu.ops.ms_deform_attn as jax_msda

    s = 256
    jmodel, params = jax_model("released")
    img = jnp.zeros((1, s, s, 3), jnp.float32)

    def k1_standin(value, spatial_shapes, loc, attn, pallas_weighting=False):
        b, _, m, d = value.shape
        return jnp.broadcast_to(value[:, :1].reshape(b, 1, m * d), (b, loc.shape[1], m * d))

    def resize_standin(x, size, method="bilinear"):
        return jnp.broadcast_to(x[..., :1, :1], x.shape[:-2] + tuple(size))

    def resize_nhwc_standin(x, size, method="bilinear"):
        return jnp.broadcast_to(x[:, :1, :1, :], (x.shape[0], *size, x.shape[-1]))

    with mock.patch.object(jax_msda, "ms_deform_attn", k1_standin), \
            mock.patch.object(jax_decoder, "resize", resize_standin), \
            mock.patch.object(jax_pixel, "resize_nhwc", resize_nhwc_standin):
        jaxpr = jax.make_jaxpr(lambda p, x: jmodel.apply(p, x, None, train=False))(params, img)
    want = _jaxpr_flops(jaxpr.jaxpr)

    tool = _tool()
    model, device = tool.build(tool.load_cfg(RELEASED, ["MODEL.DEVICE", "cpu"]))
    got = tool.forward_flops(model, s, device)
    assert got["convolution"] == want["conv"] == 17051942912
    assert got["matmul"] + got["K3"] == want["dot"]
    # K1: 6 layers over every point of the 32^2 + 16^2 + 8^2 queries, 8 heads,
    # 3 levels, 4 points, 32 channels; K3: 9 layers, 8 heads, 100 queries, the
    # keys of the three levels in turn
    assert got["K1"] == 6 * flops.k1_flops(1344 * 8 * 3 * 4, 32)
    assert got["K3"] == 3 * sum(flops.k3_flops(1, 8, 100, n, 32) for n in (64, 256, 1024))
    assert got["K1 backward"] == got["K2"] == got["K3 backward"] == 0


def test_the_tool_runs_on_the_cpu():
    """`python tools/analyze_model_torch.py ... MODEL.DEVICE cpu` prints the
    released recipe's parameter line, its structure and its counted FLOPs by
    family, and the lines parse: the families add up to the total, the
    convolutions and products are counted and so are K1 and K3, and nothing
    of a backward or of K2 (the eval forward of the released recipe)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "analyze_model_torch.py"),
         "--config-file", RELEASED, "--image-size", "64", "MODEL.DEVICE", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    m = re.fullmatch(r"#parameters: ([\d.]+) M \((\d+) parameter tensors \+ (\d+) buffers, .*\)",
                     lines[0])
    assert m and abs(float(m.group(1)) - 44.051) < 1e-3 and (m.group(2), m.group(3)) == ("344",
                                                                                        "212")
    structure = [re.fullmatch(r"  ([\w.]+): ([\d.]+) M", line) for line in lines[1:]
                 if line.endswith(" M")]
    assert all(structure) and {s.group(1) for s in structure} >= {"backbone", "sem_seg_head",
                                                                  "backbone.res5"}
    at = next(i for i, line in enumerate(lines) if line.startswith("Counted FLOPs"))
    m = re.fullmatch(r"Counted FLOPs per image @64px: ([\d.]+) GFLOPs \(counted, 2 per "
                     r"multiply-add, kernels by formula; cpu\)", lines[at])
    assert m, lines[at]
    families = dict(re.fullmatch(r"  (.+): ([\d.]+) GFLOPs", line).groups()
                    for line in lines[at + 1:])
    families = {k: float(v) for k, v in families.items()}
    assert list(families) == ["convolution", "matmul", "K1", "K1 backward", "K2", "K2 backward",
                              "K3", "K3 backward"]
    assert abs(sum(families.values()) - float(m.group(1))) < 0.01
    assert all(families[k] > 0 for k in ("convolution", "matmul", "K1", "K3"))
    assert all(families[k] == 0 for k in ("K1 backward", "K2", "K2 backward", "K3 backward"))
