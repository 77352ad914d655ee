#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, a few lines each (any failure raises, exits non-zero and prints no
result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from `mp_former_tpu_torch/csrc/` with nvcc;
3. K1 (deformable sampling) against its plain version and against the plain
   function that does the kernel's folded arithmetic, at the slice's shapes,
   float32 and bfloat16, with locations outside the map;
4. K3 (masked cross-attention) against its plain version at the decoder's
   three key lengths, float32 and bfloat16, on the strided head views the
   decoder hands it and on contiguous copies, with masks shared by the heads
   and per head, fully masked rows, a batch of two, and against the plain
   function that repeats the kernel's tiles and 3xTF32 products;
5. K2 (tap weighting) against its plain version at both call shapes of the
   800x1088 canvas, float32 and bfloat16, and at a ragged small shape;
6. the row-gather kernels against their plain versions at the shapes of
   `tools/probe_torch_row_gather.py`, then that tool's own run, counted;
7. slice 1: the released R50 COCO instance recipe at full width with
   seeded random weights serves 4 requests through `Predictor`; checks the
   outputs, that every request launched K1 6 times and K3 9 times, and that
   the kernel forward agrees with the same model run through the plain ops;
8. slice 2: the TPU recipe (head-shared sampling, tap weighting; float32)
   serves the same 4 requests: K2 18 launches per request, K3 9, K1 none;
   the kernel forward against the plain ops;
9. the per-head engine through the patch-table gather and K2
   (`TPU.PALLAS_TAP_WEIGHTING True`) with slice 1's weights: one request, K2
   18 launches, K1 none; its outputs against slice 1's K1 route;
10. evaluation: `inference_on_dataset` over 8 in-memory records on the
    slice-2 model, segm AP through the kernels and through the plain ops;
11. K1's backward kernel against `ms_deform_attn_backward_plain` and against
    autograd of the plain forward, at the 800x1088 canvas and at the training
    shape (B = 8, 512x512), model-like locations with some off the map,
    float32 and bfloat16; the forward kernel at the same shapes against its
    plain version;
12. K3's backward kernel against `masked_attention_backward_plain`, against
    autograd of the plain forward and against the plain function that repeats
    its tiled arithmetic, at the training shapes (B = 8, Q = 120, S = 256 /
    1024 / 4096) and at B = 1, Q = 100, S = 13600: per-head masks with a DN
    block, a fully blocked row, strided views; two calls give equal bits; the
    forward that writes the row statistics against the plain version, its
    output and the statistics;
13. slice 3, training: the released training recipe (DN `points`, NUM_DN 1,
    noise 0, ALL_LY_DN, label noise 0.2) at full width and depth, B = 8 images
    of 512x512 from the seeded generator: step 0's losses and gradients through
    the kernels against the same step through autograd of the plain ops, then
    1 warm and 3 timed steps through `Trainer`; checks the 61 loss keys, the
    launches per step (K1 6, K1 backward 6, K3 9, K3 backward 9, K2 0) and
    that the parameters moved;
14. slice 3, a training run that scores itself (`train_coco`): a seeded
    COCO-format dataset written to `output/chip_smoke_coco/` by
    `tools/make_synthetic_coco_torch.py` (64 train images of 640x640, 8 val
    images of 480x480, 20 classes, `.npy` images, polygon ground truth with
    some uncompressed-RLE and crowd annotations), registered as
    `coco_2017_train` / `coco_2017_val`; `Trainer(cfg)` with no loader passed
    trains the released recipe (B = 8, LSJ at 512x512, 100 target slots,
    ground truth at 1/4 of the canvas) for 12 steps from
    `build_train_loader`, and `Trainer.test` evaluates the 8 val images after
    steps 6 and 12; checks the launches (per step K1 6, K1 backward 6, K3 9,
    K3 backward 9, K2 0; per evaluated image K1 6, K3 9), the 61 finite loss
    keys and `data_time` of the `metrics.json` lines, two finite segm APs and
    at most 3 checkpoints on disk; prints s/step, data time, the batch copy
    pinned against pageable and the evaluation's s/image.

Each kernel phase also computes the kernel's bound (the least time the card
could take: bytes over the memory rate or operations over the peak rate,
whichever is larger) and times the one PyTorch call that computes the same
function, where there is one; the port itself never calls it. Every time is
read on two clocks (`mp_former_tpu_torch/utils/cuda_timing.py`): `ms`,
`plain_ms` and `library_ms` are device times (the calls captured into a CUDA
graph and replayed), `issue_ms`, `plain_issue_ms` and `library_issue_ms` the
host's time to issue one eager call; an eager caller pays the larger. Then a
JSON line with each kernel's launches, error, times and bound, the card's name
and power limit, and last the result line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"
TPU_CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_50ep_DN_query_tpu.yaml"
SEED = 0
# the slice's levels at an 800x1088 canvas: res5, res4, res3 (H, W)
MSDA_SHAPES = [(25, 34), (50, 68), (100, 136)]
ATTN_KEYS = [850, 3400, 13600]
REQUESTS = [(480, 640), (640, 480), (427, 640), (640, 427)]
# kernel vs plain tolerances (max abs error). float32: the two sum in other
# orders and round the sampling coordinate differently (loc*W-0.5 against
# grid_sample's ((2loc-1)+1)*W/2-0.5), a few ulp of outputs of magnitude ~1.
# bfloat16: the kernel's output is rounded to bfloat16 (8 bits of mantissa).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the backward kernels against their plain versions, relative to each
# gradient's largest entry. float32: other summation orders (atomics in K1's
# grad_value and K3's dq), and in K3 the forward's 3xTF32 row statistics
# against float32 recomputation (~1e-6). bfloat16: outputs rounded to 8 bits.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# against autograd of the plain forward: grid_sample rounds the sampling
# coordinate differently (see TOL), which moves a point across a pixel border
# now and then; there grad_loc, the slope of the bilinear surface, jumps. So
# grad_loc may miss on one entry in 100000.
AUTOGRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
TRAIN_SHAPES = [(16, 16), (32, 32), (64, 64)]   # res5, res4, res3 of a 512x512 image
TRAIN_BATCH, TRAIN_SIZE, TRAIN_MAX_INSTANCES = 8, 512, 20
# the released training recipe, as run_50ep_no_noise_all_ly.sh sets it
TRAIN_OVERRIDES = ["MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.DN.NUM_DN", "1",
                   "MODEL.DN.NOISE_SCALE", "0.0", "MODEL.MASK_FORMER.ALL_LY_DN", "True",
                   "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2", "SOLVER.IMS_PER_BATCH", "8",
                   "SEED", "0"]
# step 0 through the kernels against the same step through autograd of the
# plain ops (same weights, batch, draws and assignments): each loss relative to
# its value; each parameter's gradient relative to the largest gradient entry
# of that parameter. The attention masks are thresholds (sigmoid < 0.5 of
# resized logits), so a forward difference of 1e-4 flips a pixel now and then,
# which shows in the gradients of the layers behind it: 5e-3 there, three
# times the worst such run read (1.7e-3, an FFN behind the first thresholded
# mask). The parameters next to K1 and K3 (the deformable attention's and the
# cross-attention's projections) are held to 1e-3.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_KERNEL_GRAD_TOL = 1e-3, 5e-3, 1e-3
TRAIN_KERNEL_LEAVES = ("sampling_offsets", "attention_weights", "value_proj", "output_proj",
                       "transformer_cross_attention_layers")
# published peaks of one H100 SXM at its full 700 W power limit: HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense TF32 and bfloat16 tensor-core
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def bound(n_bytes: float, flops: float, dtype: str) -> dict:
    """The least time the card could take for `n_bytes` moved (each input read
    once, each output written once) and `flops` operations of type `dtype`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def mean(values) -> float:
    return sum(values) / len(values)


def timed(kernel, plain, library=None, calls: int = 20, plain_calls: int = 0) -> dict:
    """Both clocks of a kernel, its plain version and the library call
    (`plain_calls`: fewer calls a graph for a plain version with large
    intermediates)."""
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    k = two_clocks(kernel, calls)
    pl = two_clocks(plain, plain_calls or calls, iters=10 if plain_calls else 50)
    lb = two_clocks(library, calls) if library is not None else {}
    return {"ms": k["ms"], "issue_ms": k["issue_ms"],
            "plain_ms": pl["ms"], "plain_issue_ms": pl["issue_ms"],
            "library_ms": lb.get("ms"), "library_issue_ms": lb.get("issue_ms")}


def fmt_times(t: dict) -> dict:
    """The fields of `timed` for a log line."""
    return {k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in t.items()}


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "runs the port on a CUDA card only")
    sys.path.insert(0, REPO)
    from mp_former_tpu_torch.utils.cuda_timing import card_string

    card = card_string()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    return card


def phase_build() -> None:
    from mp_former_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    build_log = (lib_path.parent / "build.log").read_text()
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line:
            log("ptxas", info=line.strip())
    log("build", seconds=f"{time.perf_counter() - t0:.2f}", lib=os.path.relpath(lib_path, REPO))


def phase_k1(torch, card: str) -> dict:
    from mp_former_tpu_torch.ops import msda_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, M, D, P = 1, 8, 32, 4
    L = len(MSDA_SHAPES)
    S = sum(h * w for h, w in MSDA_SHAPES)
    value = torch.randn((B, S, M, D), generator=g, device="cuda")
    # 10% of the range lies outside [0, 1]: taps off the map read zero
    loc = torch.rand((B, S, M, L, P, 2), generator=g, device="cuda") * 1.2 - 0.1
    attn = torch.randn((B, S, M, L * P), generator=g, device="cuda").softmax(-1)
    attn = attn.view(B, S, M, L, P)
    # points with a tap on the map: 4 taps and the attention weight, one
    # multiply-add each per channel; the others cost nothing
    sizes = torch.tensor([[w, h] for h, w in MSDA_SHAPES], device="cuda").view(1, 1, 1, L, 1, 2)
    base = (loc * sizes - 0.5).floor()
    on_map = ((base >= -1) & (base <= sizes - 1)).all(-1).sum().item()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        v, lo, a = (t.to(dtype).contiguous() for t in (value, loc, attn))
        got = msda_cuda.msda_fwd(v, MSDA_SHAPES, lo, a)
        want = msda_cuda.ms_deform_attn_plain(v.float(), MSDA_SHAPES, lo.float(), a.float())
        torch.cuda.synchronize()
        folded = msda_cuda.ms_deform_attn_folded(v.float(), MSDA_SHAPES, lo.float(), a.float())
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        folded_err = (got.float() - folded).abs().max().item()
        del want, folded
        times = timed(lambda: msda_cuda.msda_fwd(v, MSDA_SHAPES, lo, a),
                      lambda: msda_cuda.ms_deform_attn_plain(v, MSDA_SHAPES, lo, a))
        bnd = bound(nbytes(v, lo, a, got), on_map * 5 * 2 * D, name)
        log("K1", dtype=name, shape=f"B{B}xQ{S}xM{M}xD{D}xL{L}xP{P}", max_abs_err=f"{err:.3e}",
            max_abs_err_vs_folded=f"{folded_err:.3e}", tol=TOL[name], **fmt_times(times),
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            points_on_map=f"{on_map}/{B * S * M * L * P}", card=repr(card))
        if not max(err, folded_err) <= TOL[name]:
            raise AssertionError(f"K1 {name}: max abs error {err} against the plain version, "
                                 f"{folded_err} against the folded one, above {TOL[name]}")
        res[name] = {"max_abs_err": err, **times, **bnd}
    return res


def phase_k3(torch, card: str) -> dict:
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    H, Q, D = 8, 100, 32

    def head_views(B, S, dtype):
        """q, k, v as `MultiheadAttention` hands them to the kernel: the
        (B, H, N, D) views of (B, N, H * D) projections, not copies."""
        return tuple(torch.randn((B, n, H * D), generator=g, device="cuda").to(dtype)
                     .view(B, n, H, D).transpose(1, 2) for n in (Q, S, S))

    def max_err(got, want):
        torch.cuda.synchronize()
        return (got.float() - want.float()).abs().max().item()

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        errs, times, bounds = [], [], []
        for S in ATTN_KEYS:
            B = 1
            q, k, v = head_views(B, S, dtype)
            mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.7
            mask[:, :5] = True  # fully masked rows: uniform over all keys
            mask_h = torch.rand((B, H, Q, S), generator=g, device="cuda") < 0.7
            err = 0.0
            for m in (mask, mask_h):
                want = mac.masked_attention_plain(q.float(), k.float(), v.float(), m)
                # where the keys lie (strided views) and as contiguous copies
                err = max(err, max_err(mac.masked_attn_fwd(q, k, v, m), want),
                          max_err(mac.masked_attn_fwd(q.contiguous(), k.contiguous(),
                                                      v.contiguous(), m), want))
            # a batch of two, strided, with a row masked in every chunk but one
            q2, k2, v2 = head_views(2, S, dtype)
            mask2 = torch.rand((2, Q, S), generator=g, device="cuda") < 0.7
            mask2[:, :5] = True
            mask2[:, 5, 64:] = True
            got = mac.masked_attn_fwd(q2, k2, v2, mask2)
            batch_err = max_err(got, mac.masked_attention_plain(q2.float(), k2.float(),
                                                                v2.float(), mask2))
            # the same tiles, chunks and 3xTF32 products in plain PyTorch
            tiled_err = max_err(got, mac.masked_attention_tiled(
                q2, k2, v2, mask2, sms=torch.cuda.get_device_properties(0).multi_processor_count))
            del q2, k2, v2, mask2, got
            # the one library call for the same function: an additive -1e9
            # mask, made outside the timed call
            additive = torch.zeros((B, 1, Q, S), dtype=dtype, device="cuda")
            additive.masked_fill_(mask[:, None], -1e9)
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=additive)
            want = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
            lib_err = (lib.float() - want).abs().max().item()
            if not lib_err <= TOL[name]:
                raise AssertionError(f"K3 {name} S={S}: the library call computes another "
                                     f"function (max abs error {lib_err})")
            t = timed(lambda: mac.masked_attn_fwd(q, k, v, mask),
                      lambda: mac.masked_attention_plain(q, k, v, mask),
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive))
            # q k^T and p v: 2 * 2 * Q * S * D per head. float32 runs them on the
            # tensor cores as 3xTF32: three times the operations, at the TF32 peak
            flops = 4.0 * B * H * Q * S * D
            n_bytes = nbytes(q, k, v, mask) + q.numel() * q.element_size()
            bnd = (bound(n_bytes, 3 * flops, "tf32") if dtype == torch.float32
                   else bound(n_bytes, flops, name))
            log("K3", dtype=name, shape=f"B{B}xH{H}xQ{Q}xS{S}xD{D}", layout="strided head views",
                max_abs_err=f"{err:.3e}", batch_of_2_max_abs_err=f"{batch_err:.3e}",
                max_abs_err_vs_tiled=f"{tiled_err:.3e}", tol=TOL[name], **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
                library="F.scaled_dot_product_attention", card=repr(card))
            if not max(err, batch_err, tiled_err) <= TOL[name]:
                raise AssertionError(f"K3 {name} S={S}: max abs error {err} (batch of two "
                                     f"{batch_err}, against the tiled plain function "
                                     f"{tiled_err}) above {TOL[name]}")
            errs.append(max(err, batch_err))
            times.append(t)
            bounds.append(bnd)
        # one decoder cycle visits each level once: report the mean per call
        res[name] = {"max_abs_err": max(errs),
                     **{key: mean([t[key] for t in times]) for key in times[0]},
                     "bound_ms": mean([b["bound_ms"] for b in bounds]),
                     "bound_by": bounds[-1]["bound_by"]}
    return res


def phase_k2(torch, card: str) -> dict:
    from mp_former_tpu_torch.ops import tap_weighting as tw

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Q = sum(h * w for h, w in MSDA_SHAPES)
    D, T = 32, 4
    # (name, B, Q, P, M): the two call shapes of one level at the 800x1088
    # canvas (every level is sampled by all Q queries), and two ragged ones
    cases = [("headshare", 1, Q, 4, 8), ("per_head", 8, Q, 4, 1),
             ("ragged", 3, 100, 12, 1), ("ragged_heads", 2, 101, 3, 8)]
    res = {}
    for case, B, q, P, M in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            taps = torch.randn((B, P * q, T * M * D), generator=g, device="cuda").to(dtype)
            # far from uniform, so a wrong row or lane order shows
            w = (torch.rand((B, P * q, T * M), generator=g, device="cuda") ** 3).to(dtype)
            got = tw.weight_taps(taps, w, P, M, D)
            want = tw.weight_taps_plain(taps.float(), w.float(), P, M, D)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            # float32: sums of T*P products in another order, the tolerance grows
            # with P. bfloat16: the output is rounded to 8 bits of mantissa,
            # half an ulp of the largest output (taps are normal, so outputs
            # reach ~10)
            tol = (TOL[name] * max(1, P // 4) if dtype == torch.float32
                   else 2.0 ** -8 * want.abs().max().item())
            del want
            taps6, w5 = taps.view(B, P, q, T, M, D), w.view(B, P, q, T, M)
            lib = torch.einsum("bpqtmd,bpqtm->bqmd", taps6, w5).reshape(B, q, M * D)
            lib_err = (lib.float() - got.float()).abs().max().item()
            del lib
            if not lib_err <= 4 * tol:
                raise AssertionError(f"K2 {case} {name}: the library call computes another "
                                     f"function (max abs difference {lib_err})")
            # few calls a graph: the plain version and einsum write a product
            # as large as the taps
            t = timed(lambda: tw.weight_taps(taps, w, P, M, D),
                      lambda: tw.weight_taps_plain(taps, w, P, M, D),
                      lambda: torch.einsum("bpqtmd,bpqtm->bqmd", taps6, w5), calls=5)
            bnd = bound(nbytes(taps, w, got), 2.0 * taps.numel(), name)
            log("K2", case=case, dtype=name, shape=f"B{B}xQ{q}xP{P}xT{T}xM{M}xD{D}",
                max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
                library="torch.einsum", card=repr(card))
            if not err <= tol:
                raise AssertionError(f"K2 {case} {name}: max abs error {err} above {tol}")
            res[(case, name)] = {"max_abs_err": err, **t, **bnd}
            del taps, w, got, taps6, w5
    return res


def phase_row_gather(torch, card: str) -> dict:
    import importlib.util

    from mp_former_tpu_torch.ops import row_gather as rg

    spec = importlib.util.spec_from_file_location(
        "probe_torch_row_gather", os.path.join(REPO, "tools", "probe_torch_row_gather.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)

    # the kernels against their plain versions (exact for the gather), timed
    res = {}
    for r in probe.run_probes(card, SEED):
        table = r["rows"] * r["width"] * r["element_size"]
        gathered = r["n"] * r["width"] * r["element_size"]
        out = (r["slots"] or r["n"]) * r["width"] * r["element_size"]
        # each input byte once: no more of the table than there is
        bnd = bound(r["n"] * r["index_size"] + min(table, gathered) + out, 0.0, "float32")
        log("row_gather", probe=r["probe"], op=r["op"], bound_ms=f"{bnd['bound_ms']:.6f}",
            bound_by=bnd["bound_by"], note="tables fit the L2 and stay warm between calls")
        res[r["probe"]] = {k: r[k] for k in (
            "max_abs_err", "ms", "issue_ms", "plain_ms", "plain_issue_ms", "library_ms",
            "library_issue_ms")} | bnd
    # the tool's own path, counted
    rg.GATHER_LAUNCHES = rg.SUM_LAUNCHES = 0
    probe.main(["--iters", "5", "--seed", str(SEED + 1)])
    launches = {"row_gather": rg.GATHER_LAUNCHES, "row_gather_sum": rg.SUM_LAUNCHES}
    log("row_gather", tool="tools/probe_torch_row_gather.py", **launches)
    if not all(launches.values()):
        raise AssertionError(f"the probe tool did not launch every row-gather kernel: {launches}")
    return {"launches": launches, **res}


def load_cfg(config: str, overrides):
    from mp_former_tpu_torch.config import get_cfg, add_deeplab_config, add_maskformer2_config

    cfg = get_cfg()
    add_deeplab_config(cfg)
    add_maskformer2_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, config))
    # as eval.sh runs the released recipe
    cfg.merge_from_list(["MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                         "MultiScaleMaskedTransformerDecoderMaskDN", *overrides])
    cfg.freeze()
    return cfg


def slice_cfg():
    return load_cfg(CONFIG, [])


def slice2_cfg():
    # the TPU recipe asks for bfloat16 compute; the slice runs it in float32
    return load_cfg(TPU_CONFIG, ["TPU.COMPUTE_DTYPE", "float32"])


def seeded_model(torch, cfg):
    from mp_former_tpu_torch.models import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return build_model(cfg)  # reference inits, seeded


def kernel_counts(backward: bool = False) -> dict:
    """The launch counts of the model's kernels; with `backward` also those of
    the two backward kernels (the serving phases compare the forward ones)."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    counts = {"msda_fwd": msda_cuda.LAUNCHES, "tap_weight_fwd": tw.LAUNCHES,
              "masked_attn_fwd": mac.LAUNCHES}
    if backward:
        counts.update(msda_bwd=msda_cuda.BWD_LAUNCHES, masked_attn_bwd=mac.BWD_LAUNCHES)
    return counts


def reset_kernel_counts() -> None:
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    msda_cuda.LAUNCHES = tw.LAUNCHES = mac.LAUNCHES = 0
    msda_cuda.BWD_LAUNCHES = mac.BWD_LAUNCHES = 0


@contextlib.contextmanager
def plain_ops():
    """Every kernel of the model replaced by its plain version, and the two
    autograd Functions by autograd of the plain versions; fails if a kernel is
    launched all the same."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import ms_deform_attn as msda_mod
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    before = kernel_counts(backward=True)
    with mock.patch.object(msda_mod, "msda_fwd", msda_cuda.ms_deform_attn_plain), \
            mock.patch.object(msda_cuda.MSDeformAttnFunction, "apply",
                              msda_cuda.ms_deform_attn_plain), \
            mock.patch.object(tw, "tap_weight_fwd", tw.weight_taps_plain), \
            mock.patch.object(mac, "masked_attn_fwd", mac.masked_attention_plain), \
            mock.patch.object(mac.MaskedAttentionFunction, "apply", mac.masked_attention_plain):
        yield
    if kernel_counts(backward=True) != before:
        raise AssertionError("the plain-op path launched a kernel")


def check_instances(cfg, requests, outs) -> None:
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    for (h, w), out in zip(requests, outs):
        inst = out["instances"]
        if inst["masks"].shape != (topk, h, w) or inst["scores"].shape != (topk,) \
                or inst["classes"].shape != (topk,):
            raise AssertionError(f"request {h}x{w}: instance shapes "
                                 f"{ {k: v.shape for k, v in inst.items()} }")
        if not np.isfinite(inst["scores"]).all():
            raise AssertionError(f"request {h}x{w}: non-finite scores")
        if not ((inst["classes"] >= 0) & (inst["classes"] < cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)).all():
            raise AssertionError(f"request {h}x{w}: class ids out of range")


def serve(torch, phase: str, cfg, predictor, images, requests, per_request: dict, card: str,
          warm_passes: int) -> dict:
    """The main path, counted: every image once through `predictor`, the
    kernels' counts set to 0 just before and read just after."""
    predictor(images[0])  # warm-up: cuDNN handles, allocator
    torch.cuda.synchronize()
    reset_kernel_counts()
    latencies, outs = [], []
    t_all = time.perf_counter()
    for img in images:
        t0 = time.perf_counter()
        outs.append(predictor(img))  # returns host arrays: ends in a sync
        latencies.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    launches = kernel_counts()
    n = len(images)
    expected = {k: v * n for k, v in per_request.items()}
    log(phase, requests=n, launches=launches, expected=expected)
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches {launches}, expected {expected}")
    check_instances(cfg, requests, outs)
    log(phase, pass_="first (each new canvas shape pays cuDNN plan and allocator set-up)",
        img_per_s=f"{n / total:.3f}", latency_ms=[round(t * 1e3, 2) for t in latencies],
        card=repr(card))
    # the same requests again, every shape now seen once
    for rep in range(warm_passes):
        latencies = []
        t_all = time.perf_counter()
        for img in images:
            t0 = time.perf_counter()
            predictor(img)
            latencies.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all
        log(phase, pass_=f"warm {rep + 1}/{warm_passes}", img_per_s=f"{n / total:.3f}",
            latency_ms=[round(t * 1e3, 2) for t in latencies], card=repr(card))
    return launches


def compare_outputs(torch, phase: str, what: str, cfg, canvas, got: dict, want: dict) -> None:
    """pred_logits within 1e-3, pred_masks within 1e-2, and no mask pixel on
    the other side of 0 unless its logit is within 5e-2 of 0."""
    got_cls, want_cls = got["pred_logits"].float(), want["pred_logits"].float()
    got_msk, want_msk = got["pred_masks"].float(), want["pred_masks"].float()
    if got_msk.shape != (1, cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES,
                         canvas.shape[1] // 4, canvas.shape[2] // 4):
        raise AssertionError(f"{phase}: pred_masks shape {tuple(got_msk.shape)}")
    if not (torch.isfinite(got_cls).all() and torch.isfinite(got_msk).all()):
        raise AssertionError(f"{phase}: non-finite kernel-path outputs")
    cls_err = (got_cls - want_cls).abs().max().item()
    msk_err = (got_msk - want_msk).abs().max().item()
    near0 = want_msk.abs() < 5e-2
    disagree = (((got_msk > 0) != (want_msk > 0)) & ~near0).sum().item()
    log(phase, compare=what, canvas=tuple(canvas.shape[1:3]),
        logits_max_abs_err=f"{cls_err:.3e}", logits_tol=1e-3,
        masks_max_abs_err=f"{msk_err:.3e}", masks_tol=1e-2,
        threshold_disagreements_off_zero=disagree,
        mask_logit_range=f"[{want_msk.min().item():.2f}, {want_msk.max().item():.2f}]")
    if not (cls_err < 1e-3 and msk_err < 1e-2 and disagree == 0):
        raise AssertionError(f"{phase}: {what} disagree")


def phase_slice(torch, card: str, phase: str, cfg, per_request: dict, warm_passes: int):
    """A full-width model with seeded weights serves REQUESTS through
    `Predictor`; then the same forward through the plain ops on the card."""
    from mp_former_tpu_torch.engine.predictor import Predictor

    model = seeded_model(torch, cfg)
    predictor = Predictor(cfg, model=model, device="cuda")
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in REQUESTS]
    launches = serve(torch, phase, cfg, predictor, images, REQUESTS, per_request, card,
                     warm_passes)
    canvas, _ = predictor.preprocess(images[0])
    with torch.inference_mode():
        k_out = model(canvas)
        with plain_ops():
            p_out = model(canvas)
    compare_outputs(torch, phase, "kernel vs plain ops", cfg, canvas, k_out, p_out)
    return launches, predictor, images, canvas, k_out


def phase_tap_weighting_route(torch, card: str, slice1_predictor, image, canvas, k1_out) -> dict:
    """Slice 1's model and weights with `TPU.PALLAS_TAP_WEIGHTING True`: the
    per-head engine through the patch-table gather and K2 instead of K1."""
    from mp_former_tpu_torch.engine.convert import load_weights
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.models import build_model

    cfg = load_cfg(CONFIG, ["TPU.PALLAS_TAP_WEIGHTING", "True"])
    model = build_model(cfg)
    load_weights(model, slice1_predictor.model.state_dict())
    predictor = Predictor(cfg, model=model, device="cuda")
    launches = serve(torch, "tap_weighting_route", cfg, predictor, [image], REQUESTS[:1],
                     {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, card, 1)
    with torch.inference_mode():
        out = predictor.model(canvas)
    compare_outputs(torch, "tap_weighting_route", "patch-table gather + K2 vs K1", cfg, canvas,
                    out, k1_out)
    return launches


def phase_eval(torch, card: str, cfg, predictor) -> dict:
    """`inference_on_dataset` over 8 in-memory records; the ground truth is
    the model's own three best predictions per image, so the AP is far from
    0 and moves with any change in the masks."""
    from mp_former_tpu_torch.engine.eval_loop import inference_on_dataset
    from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator

    rng = np.random.RandomState(SEED + 3)
    records = []
    for i, (h, w) in enumerate(REQUESTS * 2):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        inst = predictor(img)["instances"]
        annos = [{"category_id": int(inst["classes"][j]), "iscrowd": 0,
                  "area": float(inst["masks"][j].sum()), "segmentation": inst["masks"][j]}
                 for j in np.argsort(-inst["scores"])[:3] if inst["masks"][j].sum() > 40]
        records.append({"image": img, "image_id": i, "height": h, "width": w,
                        "annotations": annos})
    n_gt = sum(len(r["annotations"]) for r in records)
    if n_gt < len(records):
        raise AssertionError(f"evaluation: only {n_gt} usable ground-truth masks")
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    reset_kernel_counts()
    t0 = time.perf_counter()
    kernel = inference_on_dataset(cfg, predictor, records, COCOEvaluator(records, topk))["segm"]
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    with plain_ops():
        plain = inference_on_dataset(cfg, predictor, records, COCOEvaluator(records, topk))["segm"]
    log("evaluation", records=len(records), gt_masks=n_gt, launches=launches,
        kernel_path_AP=f"{kernel['AP']:.4f}", plain_path_AP=f"{plain['AP']:.4f}",
        kernel_path_AP50=f"{kernel['AP50']:.4f}", plain_path_AP50=f"{plain['AP50']:.4f}",
        tol=0.01, seconds_kernel_path=f"{seconds:.2f}", card=repr(card))
    aps = (kernel["AP"], plain["AP"])
    if not (all(np.isfinite(aps)) and min(aps) > 0 and abs(aps[0] - aps[1]) <= 0.01):
        raise AssertionError(f"evaluation: AP {aps[0]} through the kernels, {aps[1]} through "
                             "the plain ops")
    expected = {"msda_fwd": 0, "tap_weight_fwd": 18 * len(records),
                "masked_attn_fwd": 9 * len(records)}
    if launches != expected:
        raise AssertionError(f"evaluation: kernel launches {launches}, expected {expected}")
    return {"kernel": kernel, "plain": plain}


def rel_err(got, want) -> float:
    """max |got - want| relative to want's largest entry."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def model_like_locations(torch, g, B, shapes, M, P):
    """Sampling locations as the pixel decoder makes them: every token of every
    level is a query at its pixel centre, each point a few pixels off it
    (queries near an edge sample off the map), and 2% of the points far off."""
    refs = []
    for h, w in shapes:
        ry = (torch.arange(h, device="cuda", dtype=torch.float32) + 0.5) / h
        rx = (torch.arange(w, device="cuda", dtype=torch.float32) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs, 0)                                       # (Q, 2)
    Q, L = ref.shape[0], len(shapes)
    sizes = torch.tensor([[w, h] for h, w in shapes], device="cuda",
                         dtype=torch.float32).view(1, 1, 1, L, 1, 2)
    offsets = torch.randn((B, Q, M, L, P, 2), generator=g, device="cuda") * 3.0
    loc = ref.view(1, Q, 1, 1, 1, 2) + offsets / sizes
    far = torch.rand((B, Q, M, L, P, 1), generator=g, device="cuda") < 0.02
    return torch.where(far, loc + 2.0, loc)


def phase_k1_bwd(torch, card: str) -> dict:
    from mp_former_tpu_torch.ops import msda_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    M, D, P = 8, 32, 4
    res = {}
    for case, B, shapes in (("canvas", 1, MSDA_SHAPES), ("train", TRAIN_BATCH, TRAIN_SHAPES)):
        L = len(shapes)
        S = sum(h * w for h, w in shapes)
        value = torch.randn((B, S, M, D), generator=g, device="cuda")
        loc = model_like_locations(torch, g, B, shapes, M, P)
        attn = torch.randn((B, S, M, L * P), generator=g, device="cuda").softmax(-1)
        attn = attn.view(B, S, M, L, P)
        grad_out = torch.randn((B, S, M * D), generator=g, device="cuda")
        sizes = torch.tensor([[w, h] for h, w in shapes], device="cuda").view(1, 1, 1, L, 1, 2)
        base = (loc * sizes - 0.5).floor()
        on_map = ((base >= -1) & (base <= sizes - 1)).all(-1).sum().item()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            go, v, lo, a = (t.to(dtype).contiguous() for t in (grad_out, value, loc, attn))
            # the forward at this shape too (phase K1 holds it at B = 1 only)
            fwd_err = (msda_cuda.msda_fwd(v, shapes, lo, a).float()
                       - msda_cuda.ms_deform_attn_plain(v.float(), shapes, lo.float(),
                                                        a.float())).abs().max().item()
            got = msda_cuda.msda_bwd(go, v, shapes, lo, a)
            torch.cuda.synchronize()
            want = msda_cuda.ms_deform_attn_backward_plain(go.float(), v.float(), shapes,
                                                           lo.float(), a.float())
            errs = [rel_err(x, w) for x, w in zip(got, want)]
            abs_err = max((x.float() - w).abs().max().item() for x, w in zip(got, want))
            # autograd of the plain forward
            leaves = [t.float().clone().requires_grad_() for t in (v, lo, a)]
            out = msda_cuda.ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2])
            auto = torch.autograd.grad(out, leaves, go.float())
            auto_errs = [rel_err(got[0], auto[0]), rel_err(got[2], auto[2])]
            loc_miss = ((got[1].float() - auto[1]).abs()
                        > AUTOGRAD_TOL[name] * auto[1].abs().max()).float().mean().item()
            del want, auto, out, leaves
            times = timed(lambda: msda_cuda.msda_bwd(go, v, shapes, lo, a),
                          lambda: msda_cuda.ms_deform_attn_backward_plain(go, v, shapes, lo, a),
                          plain_calls=2)
            # per tap on the map: the dot product with g and the add of w * g
            bnd = bound(nbytes(go, v, lo, a, got[1], got[2]) + v.numel() * 4,
                        on_map * 4 * 4 * D, name)
            log("K1_bwd", case=case, dtype=name, shape=f"B{B}xQ{S}xM{M}xD{D}xL{L}xP{P}",
                rel_err_value_loc_attn=[f"{e:.2e}" for e in errs], tol=BWD_TOL[name],
                max_abs_err=f"{abs_err:.3e}", forward_max_abs_err=f"{fwd_err:.3e}",
                forward_tol=TOL[name], rel_err_vs_autograd_value_attn=[f"{e:.2e}" for e in auto_errs],
                grad_loc_share_off_vs_autograd=f"{loc_miss:.2e}", autograd_tol=AUTOGRAD_TOL[name],
                grad_value_reproducible="to rounding only (float32 atomics, in no fixed order)",
                **fmt_times(times), bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
                points_on_map=f"{on_map}/{B * S * M * L * P}", card=repr(card))
            if not fwd_err <= TOL[name]:
                raise AssertionError(f"K1 forward {case} {name}: max abs error {fwd_err} against "
                                     f"the plain version, above {TOL[name]}")
            if not max(errs) <= BWD_TOL[name]:
                raise AssertionError(f"K1 backward {case} {name}: relative errors {errs} "
                                     f"against the plain backward, above {BWD_TOL[name]}")
            if not (max(auto_errs) <= AUTOGRAD_TOL[name] and loc_miss <= 1e-5):
                raise AssertionError(f"K1 backward {case} {name}: against autograd of the plain "
                                     f"forward {auto_errs}, grad_loc off on {loc_miss} of entries")
            res[(case, name)] = {"max_abs_err": abs_err, **times, **bnd}
            del got, go, v, lo, a
    return res


def phase_k3_bwd(torch, card: str) -> dict:
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, D, DN = 8, 32, 20
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        per_shape = []
        for B, Q, S in ((8, 120, 256), (8, 120, 1024), (8, 120, 4096), (1, 100, 13600)):
            # strided head views of (B, N, H * D) projections, as the decoder's
            q, k, v = (torch.randn((B, n, H * D), generator=g, device="cuda").to(dtype)
                       .view(B, n, H, D).transpose(1, 2) for n in (Q, S, S))
            go = torch.randn((B, Q, H, D), generator=g, device="cuda").to(dtype).transpose(1, 2)
            # the learnable queries' rows are shared by the heads; the DN block in
            # front is per head; row 0 is blocked everywhere
            shared = torch.rand((B, 1, Q, S), generator=g, device="cuda") < 0.7
            mask = shared.expand(B, H, Q, S).clone()
            mask[:, :, :DN] = torch.rand((B, H, DN, S), generator=g, device="cuda") < 0.9
            mask[:, :, 0] = True
            out, stats = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
            # the forward that writes the statistics is an instantiation of its
            # own: its output against the plain version, and the statistics
            # against the plain logits' row maximum (base 2, relative: a row
            # blocked everywhere has -1e9 log2 e) and log2 of the row's sum
            fwd_err = (out.float() - mac.masked_attention_plain(
                q.float(), k.float(), v.float(), mask)).abs().max().item()
            logits = (torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) / math.sqrt(D)
                      ).masked_fill_(mask, -1e9)
            row_max = logits.amax(-1)
            log2_sum = (logits - row_max[..., None]).exp_().sum(-1).log2()
            row_max = row_max * math.log2(math.e)
            max_err = ((stats[..., 0] - row_max).abs() / row_max.abs().clamp(min=1.0)).max().item()
            sum_err = (stats[..., 1].log2() - log2_sum).abs().max().item()
            del logits, row_max, log2_sum
            got = mac.masked_attn_bwd(go, q, k, v, mask, out, stats)
            torch.cuda.synchronize()
            want = mac.masked_attention_backward_plain(go.float(), q.float(), k.float(),
                                                       v.float(), mask)
            errs = [rel_err(x, w) for x, w in zip(got, want)]
            abs_err = max((x.float() - w).abs().max().item() for x, w in zip(got, want))
            blocked_row_dq = got[0][:, :, 0].abs().max().item()
            # dq is summed over the key chunks in a fixed order: two calls, equal bits
            again = mac.masked_attn_bwd(go, q, k, v, mask, out, stats)
            reproducible = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            tiled_errs = [rel_err(x, w) for x, w in zip(
                got, mac.masked_attention_backward_tiled(go, q, k, v, mask, out, stats))]
            # through the Function, against autograd of the plain forward
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            mac.masked_attention(*leaves, mask).backward(go)
            plain_leaves = [t.detach().float().clone().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(mac.masked_attention_plain(*plain_leaves, mask),
                                       plain_leaves, go.float())
            auto_errs = [rel_err(leaf.grad, w) for leaf, w in zip(leaves, auto)]
            del want, auto, leaves, plain_leaves
            # the one library call for the same function: the backward of SDPA with
            # an additive -1e9 mask. On a row blocked everywhere SDPA's backward
            # computes something else (its forward does not), so the library gets
            # the same mask with one key of that row open, and is held against
            # the plain backward on that mask
            lib_mask = mask.clone()
            lib_mask[:, :, 0, 0] = False
            additive = torch.zeros((B, H, Q, S), dtype=dtype, device="cuda")
            additive.masked_fill_(lib_mask, -1e9)
            lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=additive)
            lib_grads = torch.autograd.grad(lib_out, lib_leaves, go, retain_graph=True)
            lib_want = mac.masked_attention_backward_plain(go.float(), q.float(), k.float(),
                                                           v.float(), lib_mask)
            lib_err = max(rel_err(x, w) for x, w in zip(lib_grads, lib_want))
            del lib_grads, lib_want, lib_mask
            if not lib_err <= AUTOGRAD_TOL[name]:
                raise AssertionError(f"K3 backward {name} S={S}: the library call computes "
                                     f"another function (relative error {lib_err})")
            t = timed(lambda: mac.masked_attn_bwd(go, q, k, v, mask, out, stats),
                      lambda: mac.masked_attention_backward_plain(go, q, k, v, mask),
                      calls=10, plain_calls=2)
            # a backward cannot be captured apart from its forward (the engine ties
            # it to the forward's stream): the library's time is forward and
            # backward together less the forward alone, each by graph replay

            def lib_forward(backward=False):
                # fresh leaves: autograd ties a leaf to the stream it was made on
                leaves = [t.detach().requires_grad_(backward) for t in (q, k, v)]
                lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=additive)
                return torch.autograd.grad(lib_out, leaves, go) if backward else lib_out

            both = two_clocks(lambda: lib_forward(backward=True), 10)
            alone = two_clocks(lib_forward, 10)
            t["library_ms"] = both["ms"] - alone["ms"]
            t["library_issue_ms"] = both["issue_ms"] - alone["issue_ms"]
            # five products of 2 Q S D operations per head; as in the forward's
            # bound, float32 accuracy on the tensor cores is 3xTF32: three times
            # the operations at the TF32 peak
            flops = 5 * 2.0 * B * H * Q * S * D
            n_bytes = nbytes(q, k, v, out, go, mask, stats, *got)
            bnd = (bound(n_bytes, 3 * flops, "tf32") if dtype == torch.float32
                   else bound(n_bytes, flops, name))
            log("K3_bwd", dtype=name, shape=f"B{B}xH{H}xQ{Q}xS{S}xD{D}",
                layout="strided head views, per-head mask with a DN block",
                rel_err_dq_dk_dv=[f"{e:.2e}" for e in errs], tol=BWD_TOL[name],
                max_abs_err=f"{abs_err:.3e}", blocked_row_max_abs_dq=blocked_row_dq,
                forward_max_abs_err=f"{fwd_err:.3e}", stats_max_rel_err=f"{max_err:.3e}",
                stats_log2_sum_abs_err=f"{sum_err:.3e}", forward_tol=TOL[name],
                rel_err_vs_autograd=[f"{e:.2e}" for e in auto_errs],
                autograd_tol=AUTOGRAD_TOL[name],
                rel_err_vs_tiled_arithmetic=[f"{e:.2e}" for e in tiled_errs],
                bitwise_reproducible=reproducible, **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
                library="backward of F.scaled_dot_product_attention (forward and backward "
                        "less the forward)", card=repr(card))
            if not max(fwd_err, max_err, sum_err) <= TOL[name]:
                raise AssertionError(f"K3 forward with statistics {name} S={S}: output "
                                     f"{fwd_err}, row maximum {max_err}, log2 of the row sum "
                                     f"{sum_err} against the plain version, above {TOL[name]}")
            if not (reproducible and max(tiled_errs) <= BWD_TOL[name]):
                raise AssertionError(f"K3 backward {name} S={S}: two calls differ "
                                     f"({reproducible=}), or {tiled_errs} against the kernel's "
                                     "tiled arithmetic")
            if not (max(errs) <= BWD_TOL[name] and blocked_row_dq == 0.0):
                raise AssertionError(f"K3 backward {name} S={S}: relative errors {errs} against "
                                     f"the plain backward above {BWD_TOL[name]}, or a gradient "
                                     f"{blocked_row_dq} to the q of a row blocked everywhere")
            if not max(auto_errs) <= AUTOGRAD_TOL[name]:
                raise AssertionError(f"K3 backward {name} S={S}: {auto_errs} against autograd "
                                     "of the plain forward")
            per_shape.append({"max_abs_err": abs_err, **t, **bnd})
            del q, k, v, go, mask, shared, additive, out, stats, got, lib_leaves, lib_out
        # a training step visits each of the three training lengths three times:
        # report their mean per call (the S = 13600 shape is checked, not averaged)
        train = per_shape[:3]
        res[name] = {"max_abs_err": max(r["max_abs_err"] for r in per_shape),
                     **{key: mean([r[key] for r in train])
                        for key in ("ms", "issue_ms", "plain_ms", "plain_issue_ms", "library_ms",
                                    "library_issue_ms", "bound_ms")},
                     "bound_by": train[-1]["bound_by"]}
    return res


TRAIN_EXPECTED = {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9, "msda_bwd": 6,
                  "masked_attn_bwd": 9}


def loss_and_gradients(torch, model, criterion, batch, assignments=None):
    """Step 0 without the update: (losses, {name: gradient}, assignments). The
    draws come from a generator seeded anew, and the matcher's points are drawn
    whether or not `assignments` are given, so two calls see the same noise."""
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model.zero_grad(set_to_none=True)
    outputs = model(batch.images, batch.targets, generator=generator)
    costs = criterion.layer_costs(outputs, batch.targets, generator)
    if assignments is None:
        assignments = criterion.assign(costs)
    losses = criterion(outputs, batch.targets, generator, assignments=assignments)
    criterion.weighted_total(losses).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: v.item() for k, v in losses.items()}, grads, assignments


def phase_train(torch, card: str) -> dict:
    """Slice 3: the released training recipe at full width and depth."""
    import shutil

    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    out_dir = os.path.join(REPO, "output", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "OUTPUT_DIR", out_dir])
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    model, criterion = trainer.model, trainer.criterion
    first = next(batches).to("cuda")

    # step 0 through the kernels and through autograd of the plain ops
    reset_kernel_counts()
    k_losses, k_grads, assignments = loss_and_gradients(torch, model, criterion, first)
    launches = kernel_counts(backward=True)
    if launches != TRAIN_EXPECTED:
        raise AssertionError(f"train: kernel launches of one step {launches}, expected "
                             f"{TRAIN_EXPECTED}")
    with plain_ops():
        p_losses, p_grads, _ = loss_and_gradients(torch, model, criterion, first, assignments)
    loss_err = max(abs(k_losses[k] - p_losses[k]) / max(abs(p_losses[k]), 1e-6) for k in p_losses)
    if k_grads.keys() != p_grads.keys():
        raise AssertionError("train: the two paths give gradients to different parameters")
    grad_errs = sorted(((rel_err(k_grads[n], p_grads[n]), n) for n in p_grads), reverse=True)
    within = sum(e <= 1e-3 for e, _ in grad_errs)
    kernel_errs = [(e, n) for e, n in grad_errs if any(s in n for s in TRAIN_KERNEL_LEAVES)]
    log("train", compare="step 0, kernels vs autograd of the plain ops", losses=len(k_losses),
        loss_max_rel_err=f"{loss_err:.3e}", loss_tol=TRAIN_LOSS_TOL,
        gradients=len(grad_errs), grad_max_rel_err=f"{grad_errs[0][0]:.3e}",
        grad_tol=TRAIN_GRAD_TOL, gradients_within_1e_3=within,
        gradients_next_to_kernels=len(kernel_errs),
        kernel_grad_max_rel_err=f"{kernel_errs[0][0]:.3e}", kernel_grad_tol=TRAIN_KERNEL_GRAD_TOL,
        worst=[(n, f"{e:.2e}") for e, n in grad_errs[:3]])
    if not (loss_err <= TRAIN_LOSS_TOL and grad_errs[0][0] <= TRAIN_GRAD_TOL
            and kernel_errs and kernel_errs[0][0] <= TRAIN_KERNEL_GRAD_TOL):
        raise AssertionError(f"train: step 0 through the kernels and through the plain ops "
                             f"disagree: losses {loss_err}, gradients {grad_errs[:3]}, next "
                             f"to the kernels {kernel_errs[:3]}")
    if not all(torch.isfinite(g).all() for g in k_grads.values()):
        raise AssertionError("train: non-finite gradients")
    del k_grads, p_grads
    model.zero_grad(set_to_none=True)

    # the main path: 1 warm step and 3 timed steps through the trainer
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if p.requires_grad and n.endswith(("query_feat.weight", "res5.2.conv3.weight",
                                                  "value_proj.weight", "in_proj_weight"))}
    reset_kernel_counts()
    criterion.matcher_host_seconds = 0.0
    torch.cuda.synchronize()
    seconds, metrics = [], None
    for step, batch in zip(range(4), itertools.chain([first], batches)):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = trainer.run_step(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = kernel_counts(backward=True)
    expected = {k: 4 * v for k, v in TRAIN_EXPECTED.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in metrics.items()}
    log("train", steps=4, launches=launches, expected=expected)
    log("train", warm_step_s=f"{seconds[0]:.3f}", timed_steps_s=[f"{t:.4f}" for t in seconds[1:]],
        peak_memory_allocated_GiB=f"{peak_gb:.2f}",
        matcher_host_s_per_step=f"{criterion.matcher_host_seconds / 4:.4f}",
        total_loss=f"{metrics['total_loss']:.3f}", lr=trainer.scheduler.get_last_lr()[-1],
        batch=f"{TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"train: kernel launches {launches}, expected {expected}")
    keys = [k + d + s for k in ("loss_ce", "loss_mask", "loss_dice") for d in ("", "_dn")
            for s in ("", *(f"_{i}" for i in range(cfg.MODEL.MASK_FORMER.DEC_LAYERS - 1)))]
    missing = [k for k in (*keys, "total_loss") if k not in metrics]
    if missing or len(metrics) != 61 or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"train: {len(metrics)} loss keys, missing {missing}, or a "
                             "non-finite loss")
    moved = {n: (p.detach() - watched[n]).abs().max().item()
             for n, p in model.named_parameters() if n in watched}
    if not moved or not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train: parameters did not move: {moved}")
    log("train", parameters_watched=len(moved), all_moved=True, ok=True)
    return launches


COCO_ROOT = os.path.join(REPO, "output", "chip_smoke_coco")
COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_CLASSES = 64, 8, 20
COCO_STEPS, COCO_EVAL_PERIOD, COCO_CHECKPOINT_PERIOD = 12, 6, 3
COCO_EVAL_EXPECTED = {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9, "msda_bwd": 0,
                      "masked_attn_bwd": 0}


def uncompressed_rle(mask) -> dict:
    """(H, W) bool -> COCO's uncompressed RLE (column-major runs, background
    first)."""
    flat = mask.T.reshape(-1).astype(np.uint8)
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return {"size": list(mask.shape), "counts": ([0] if flat[0] else []) + runs}


def write_coco(root: str) -> dict:
    """The phase's dataset; every 5th annotation's polygons become
    uncompressed RLE and every 11th (from the 4th) a crowd annotation, so that
    every branch of the mapper and the evaluator runs."""
    from mp_former_tpu_torch.native import polygons_to_mask
    from tools.make_synthetic_coco_torch import write_dataset

    counts = {}
    for split, n, size, seed in (("train2017", COCO_TRAIN_IMAGES, 640, SEED),
                                 ("val2017", COCO_VAL_IMAGES, 480, SEED + 1)):
        path = write_dataset(root, n, size, COCO_CLASSES, split, seed)
        with open(path) as f:
            data = json.load(f)
        for k, a in enumerate(data["annotations"]):
            if k % 5 == 1:
                a["segmentation"] = uncompressed_rle(polygons_to_mask(a["segmentation"], size, size))
            elif k % 11 == 3:
                a["iscrowd"] = 1
        with open(path, "w") as f:
            json.dump(data, f)
        kinds = [("rle" if isinstance(a["segmentation"], dict) else "polygon")
                 + ("_crowd" if a["iscrowd"] else "") for a in data["annotations"]]
        counts[split] = {k: kinds.count(k) for k in sorted(set(kinds))}
    return counts


def copy_ms(torch, batch, non_blocking: bool, reps: int = 5) -> float:
    """Median host time of one batch copy to the card, synchronised."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch.to("cuda", non_blocking=non_blocking)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def hold_evaluation(torch, cfg, model, kernel_segm: dict) -> dict:
    """The evaluation's shapes held against the plain ops: the val images'
    800x800 canvas gives K1 Q = S = 13125 and K3 S = 625 / 2500 / 10000,
    which phases K1 and K3 do not run. For each val image, the model's
    outputs through the kernels against the plain ops (`compare_outputs`),
    and the `Predictor`'s instances: sorted scores within 1e-3, and over the
    detections that keep their rank, class and score (within 1e-4) the masks'
    pooled IoU at least 0.99. Then the plain path's instances scored by the
    evaluator against the last `Trainer.test` (the same weights): segm AP
    within 0.01."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.evaluation.build import build_evaluator

    records = DatasetCatalog.get("coco_2017_val")[:COCO_VAL_IMAGES]
    predictor = Predictor(cfg, model=model, device="cuda")
    evset = build_evaluator(cfg, "coco_2017_val", records)
    evset.reset()
    score_err, inter, union, kept = 0.0, 0, 0, 0
    for rec in records:
        image = read_image(rec)
        canvas, _ = predictor.preprocess(image)
        with torch.inference_mode():
            k_out = model(canvas)
            with plain_ops():
                p_out = model(canvas)
        compare_outputs(torch, "train_coco", f"val image {rec['image_id']}: kernel vs plain ops",
                        cfg, canvas, k_out, p_out)
        hw = (rec["height"], rec["width"])
        k = predictor(image, hw)["instances"]
        with plain_ops():
            p = predictor(image, hw)["instances"]
        evset.process(rec, {"instance": (p["scores"], p["classes"], p["masks"])})
        score_err = max(score_err, float(np.abs(np.sort(k["scores"]) - np.sort(p["scores"])).max()))
        same = (k["classes"] == p["classes"]) & (np.abs(k["scores"] - p["scores"]) < 1e-4)
        inter += int((k["masks"][same] & p["masks"][same]).sum())
        union += int((k["masks"][same] | p["masks"][same]).sum())
        kept += int(same.sum())
    plain_segm = evset.evaluate()["segm"]
    iou = inter / union if union else 1.0  # all kept masks empty on both sides: the same
    log("train_coco", compare="evaluation, kernel vs plain ops", images=len(records),
        canvas=tuple(canvas.shape[1:3]), sorted_scores_max_abs_err=f"{score_err:.3e}",
        scores_tol=1e-3, detections_kept=kept, mask_pixels_union=union,
        masks_pooled_iou=f"{iou:.6f}", iou_min=0.99,
        kernel_AP=f"{kernel_segm['AP']:.4f}", plain_AP=f"{plain_segm['AP']:.4f}", ap_tol=0.01)
    if not (score_err < 1e-3 and kept > 0 and iou >= 0.99
            and abs(kernel_segm["AP"] - plain_segm["AP"]) <= 0.01):
        raise AssertionError("train_coco: the evaluation disagrees between the kernels and the "
                             "plain ops")
    return {"scores_err": score_err, "masks_iou": iou, "plain_segm": plain_segm}


def phase_train_coco(torch, card: str) -> dict:
    """Slice 3, the rest: a training run from a COCO-format dataset on disk,
    scored by `Trainer.test` every COCO_EVAL_PERIOD steps."""
    import shutil

    from mp_former_tpu_torch.data.catalog import MetadataCatalog
    from mp_former_tpu_torch.data.datasets.coco import register_all_coco
    from mp_former_tpu_torch.data.loader import build_train_loader
    from mp_former_tpu_torch.data.synthetic import synthetic_batch
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.structures import Batch, Targets

    out_dir = os.path.join(REPO, "output", "chip_smoke_train_coco")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(COCO_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    kinds = write_coco(COCO_ROOT)
    log("train_coco", dataset=os.path.relpath(COCO_ROOT, REPO), annotations=kinds,
        write_s=f"{time.perf_counter() - t0:.2f}")
    # the two names under this root, before anything imports the builtin
    # registrations (which would register them under $DETECTRON2_DATASETS)
    register_all_coco(COCO_ROOT)
    for name in ("coco_2017_train", "coco_2017_val"):
        if not MetadataCatalog.get(name).json_file.startswith(COCO_ROOT):
            raise AssertionError(f"train_coco: {name} is registered elsewhere: "
                                 f"{MetadataCatalog.get(name).json_file}")
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "INPUT.IMAGE_SIZE", str(TRAIN_SIZE),
                            "SOLVER.MAX_ITER", str(COCO_STEPS),
                            "SOLVER.CHECKPOINT_PERIOD", str(COCO_CHECKPOINT_PERIOD),
                            "TEST.EVAL_PERIOD", str(COCO_EVAL_PERIOD), "OUTPUT_DIR", out_dir])
    cfg.defrost()
    cfg.TEST.MAX_EVAL_IMAGES = COCO_VAL_IMAGES  # read as the JAX trainer reads it: TEST.get
    cfg.freeze()
    if (cfg.INPUT.DATASET_MAPPER_NAME, cfg.TPU.MAX_INSTANCES, cfg.DATASETS.TRAIN,
            cfg.DATASETS.TEST) != ("coco_instance_lsj", 100, ("coco_2017_train",),
                                   ("coco_2017_val",)):
        raise AssertionError("train_coco: the recipe's data settings changed")
    trainer = Trainer(cfg, model=seeded_model(torch, cfg), device="cuda")

    step_s, shapes = [], []
    run_step = trainer.run_step

    def timed_step(batch):
        if not shapes:
            shapes.append({"images": (tuple(batch.images.shape), str(batch.images.dtype),
                                      batch.images.is_pinned()),
                           "masks": (tuple(batch.targets.masks.shape),
                                     str(batch.targets.masks.dtype))})
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    results, eval_s, eval_launches = [], [], {k: 0 for k in COCO_EVAL_EXPECTED}
    test = trainer.test

    def timed_test(max_images=None):
        before = kernel_counts(backward=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        results.append(test(max_images))
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t)
        for k, v in kernel_counts(backward=True).items():
            eval_launches[k] += v - before[k]
        return results[-1]

    trainer.run_step, trainer.test = timed_step, timed_test
    # the main path, counted
    reset_kernel_counts()
    t0 = time.perf_counter()
    trainer.train()
    total_s = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    train_launches = {k: launches[k] - eval_launches[k] for k in launches}
    n_eval = COCO_VAL_IMAGES * len(results)
    expected_train = {k: COCO_STEPS * v for k, v in TRAIN_EXPECTED.items()}
    expected_eval = {k: n_eval * v for k, v in COCO_EVAL_EXPECTED.items()}
    log("train_coco", steps=COCO_STEPS, train_launches=train_launches, expected=expected_train)
    log("train_coco", evaluations=len(results), images=n_eval, eval_launches=eval_launches,
        expected=expected_eval)
    if train_launches != expected_train or eval_launches != expected_eval or len(results) != 2:
        raise AssertionError(f"train_coco: launches {train_launches} / {eval_launches} over "
                             f"{len(results)} evaluations, expected {expected_train} / "
                             f"{expected_eval} over 2")
    want_shapes = {"images": ((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), "torch.uint8", True),
                   "masks": ((TRAIN_BATCH, 100, TRAIN_SIZE // 4, TRAIN_SIZE // 4), "torch.bool")}
    if shapes[0] != want_shapes:
        raise AssertionError(f"train_coco: loader batch {shapes[0]}, expected {want_shapes}")

    with open(os.path.join(out_dir, "metrics.json")) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    keys = [k + d + s for k in ("loss_ce", "loss_mask", "loss_dice") for d in ("", "_dn")
            for s in ("", *(f"_{i}" for i in range(cfg.MODEL.MASK_FORMER.DEC_LAYERS - 1)))]
    for line in lines:
        losses = {k: v for k, v in line.items() if k.startswith("loss_") or k == "total_loss"}
        missing = [k for k in (*keys, "total_loss") if k not in losses]
        if missing or len(losses) != 61 or not all(np.isfinite(v) for v in line.values()) \
                or "data_time" not in line:
            raise AssertionError(f"train_coco: metrics line {line.get('iteration')}: "
                                 f"{len(losses)} loss keys, missing {missing}, data_time "
                                 f"{line.get('data_time')}, or a non-finite value")
    if [x["iteration"] for x in lines] != [0, COCO_STEPS - 1]:
        raise AssertionError(f"train_coco: metrics lines {[x['iteration'] for x in lines]}")
    aps = [r["segm"]["AP"] for r in results]
    if not all(np.isfinite(aps)):
        raise AssertionError(f"train_coco: segm AP {aps}")
    ckpts = sorted(f for f in os.listdir(os.path.join(out_dir, "checkpoints"))
                   if f.endswith(".pth"))
    if len(ckpts) > 3 or ckpts[-1] != f"model_{COCO_STEPS:07d}.pth":
        raise AssertionError(f"train_coco: checkpoints {ckpts}")
    hold_evaluation(torch, cfg, trainer.model, results[-1]["segm"])

    # the batch copy: a loader batch pinned and pageable, and phase train's batch
    loader = build_train_loader(cfg, pin_memory=True)
    try:
        pinned = next(loader)
    finally:
        loader.close()
    pageable = Batch(pinned.images.clone(), Targets(*(t.clone() for t in pinned.targets)))
    if pageable.images.is_pinned() or not pinned.images.is_pinned():
        raise AssertionError("train_coco: the copy comparison lost its pinned/pageable split")
    generated = synthetic_batch(np.random.RandomState(SEED), TRAIN_BATCH, TRAIN_SIZE,
                                COCO_CLASSES, TRAIN_MAX_INSTANCES)
    copies = {"pinned_ms": copy_ms(torch, pinned, True),
              "pageable_ms": copy_ms(torch, pageable, False),
              "generated_pageable_ms": copy_ms(torch, generated, False)}
    mb = {"loader_batch_MB": nbytes(pinned.images, *pinned.targets) / 1e6,
          "generated_batch_MB": nbytes(generated.images, *generated.targets) / 1e6}

    first_data, last = lines[0]["data_time"], lines[-1]
    steady_data = (last["data_time"] * COCO_STEPS - first_data) / (COCO_STEPS - 1)
    res = {"s_per_step": mean(step_s[1:]), "first_step_s": step_s[0],
           "data_time_s": last["data_time"], "data_time_first_s": first_data,
           "data_time_steady_s": steady_data, **copies, **mb,
           "eval_s_per_image": [t / COCO_VAL_IMAGES for t in eval_s], "segm_AP": aps,
           "wall_s": total_s}
    log("train_coco", s_per_step=f"{res['s_per_step']:.4f}",
        steps_s=[f"{t:.4f}" for t in step_s], card=repr(card))
    log("train_coco", data_time_s=f"{last['data_time']:.4f}", first_step_data_s=f"{first_data:.4f}",
        data_time_after_first_s=f"{steady_data:.4f}", card=repr(card))
    log("train_coco", batch_copy_pinned_ms=f"{copies['pinned_ms']:.3f}",
        batch_copy_pageable_ms=f"{copies['pageable_ms']:.3f}",
        loader_batch_MB=f"{mb['loader_batch_MB']:.1f}",
        generated_batch_pageable_ms=f"{copies['generated_pageable_ms']:.3f}",
        generated_batch_MB=f"{mb['generated_batch_MB']:.1f}", card=repr(card))
    log("train_coco", eval_s_per_image=[f"{t:.4f}" for t in res["eval_s_per_image"]],
        segm_AP=[f"{a:.4f}" for a in aps], checkpoints=ckpts, train_wall_s=f"{total_s:.2f}",
        card=repr(card))
    log("train_coco", ok=True)
    return train_launches


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    k1 = phase_k1(torch, card)
    k3 = phase_k3(torch, card)
    k2 = phase_k2(torch, card)
    gather = phase_row_gather(torch, card)
    # reference numerics: float32 convolutions and matmuls in full float32
    # (cuDNN's default is TF32, which keeps ~3 decimal digits)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s1, predictor1, images, canvas, k1_out = phase_slice(
        torch, card, "slice", slice_cfg(),
        {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9}, warm_passes=1)
    cfg2 = slice2_cfg()
    s2, predictor2, _, _, _ = phase_slice(
        torch, card, "slice2", cfg2,
        {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, warm_passes=1)
    route = phase_tap_weighting_route(torch, card, predictor1, images[0], canvas, k1_out)
    phase_eval(torch, card, cfg2, predictor2)
    del predictor1, predictor2, k1_out
    torch.cuda.empty_cache()
    k1_bwd = phase_k1_bwd(torch, card)
    k3_bwd = phase_k3_bwd(torch, card)
    train = phase_train(torch, card)
    torch.cuda.empty_cache()
    train_coco = phase_train_coco(torch, card)
    by_path = {"slice": s1, "slice2": s2, "tap_weighting_route": route, "train": train,
               "train_coco": train_coco}
    csrc = "mp_former_tpu_torch/csrc/"
    kernels = [
        {"name": "msda_fwd", "route": "cuda", "source": csrc + "msda_fwd.cu",
         "replaces": "mp_former_tpu/ops/msda_pallas.py:134", "launches": s1["msda_fwd"],
         **k1["float32"]},
        {"name": "masked_attn_fwd", "route": "cuda", "source": csrc + "masked_attn_fwd.cu",
         "replaces": "mp_former_tpu/ops/fused_masked_attention.py:63",
         "launches": s1["masked_attn_fwd"], **k3["float32"]},
        {"name": "tap_weight_fwd", "route": "cuda", "source": csrc + "tap_weight_fwd.cu",
         "replaces": "mp_former_tpu/ops/tap_weighting.py:244", "launches": s2["tap_weight_fwd"],
         **k2[("headshare", "float32")]},
        {"name": "row_gather", "route": "cuda", "source": csrc + "row_gather.cu",
         "replaces": "tools/bench_sampling_engines.py:259; tools/probe_msda_kernel.py:39",
         "launches": gather["launches"]["row_gather"], **gather["P3"]},
        {"name": "row_gather_sum", "route": "cuda", "source": csrc + "row_gather.cu",
         "replaces": "tools/bench_sampling_engines.py:279",
         "launches": gather["launches"]["row_gather_sum"], **gather["P2"]},
        {"name": "msda_bwd", "route": "cuda", "source": csrc + "msda_bwd.cu",
         "replaces": "mp_former_tpu/ops/msda_pallas.py:249 (the VJP of the kernel at :134, "
                     "a recompute through XLA)",
         "launches": train["msda_bwd"], **k1_bwd[("train", "float32")]},
        {"name": "masked_attn_bwd", "route": "cuda", "source": csrc + "masked_attn_bwd.cu",
         "replaces": "mp_former_tpu/ops/fused_masked_attention.py:63 (no VJP: training takes "
                     "the einsum branch, mp_former_tpu/models/transformer_decoder/"
                     "primitives.py:72)",
         "launches": train["masked_attn_bwd"], **k3_bwd["float32"]},
    ]
    for kern in kernels:
        kern["launches_by_path"] = {p: c[kern["name"]] for p, c in by_path.items()
                                    if kern["name"] in c}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
