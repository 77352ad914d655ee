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
   three key lengths, with random masks and fully masked rows;
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
    slice-2 model, segm AP through the kernels and through the plain ops.

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
import json
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
# published peaks of one H100 SXM at its full 700 W power limit: HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense bfloat16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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


def timed(kernel, plain, library=None, calls: int = 20) -> dict:
    """Both clocks of a kernel, its plain version and the library call."""
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    k, pl = two_clocks(kernel, calls), two_clocks(plain, calls)
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
    B, H, Q, D = 1, 8, 100, 32
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        errs, times, bounds = [], [], []
        for S in ATTN_KEYS:
            q = torch.randn((B, H, Q, D), generator=g, device="cuda").to(dtype)
            k = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
            v = torch.randn((B, H, S, D), generator=g, device="cuda").to(dtype)
            mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.7
            mask[:, :5] = True  # fully masked rows: uniform over all keys
            mask_h = torch.rand((B, H, Q, S), generator=g, device="cuda") < 0.7
            err = 0.0
            for m in (mask, mask_h):
                got = mac.masked_attn_fwd(q, k, v, m)
                want = mac.masked_attention_plain(q.float(), k.float(), v.float(), m)
                torch.cuda.synchronize()
                err = max(err, (got.float() - want).abs().max().item())
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
            # q k^T and p v: 2 * 2 * Q * S * D per head
            bnd = bound(nbytes(q, k, v, mask, got), 4.0 * B * H * Q * S * D, name)
            log("K3", dtype=name, shape=f"B{B}xH{H}xQ{Q}xS{S}xD{D}", max_abs_err=f"{err:.3e}",
                tol=TOL[name], **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
                library="F.scaled_dot_product_attention", card=repr(card))
            if not err <= TOL[name]:
                raise AssertionError(f"K3 {name} S={S}: max abs error {err} above {TOL[name]}")
            errs.append(err)
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


def kernel_counts() -> dict:
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    return {"msda_fwd": msda_cuda.LAUNCHES, "tap_weight_fwd": tw.LAUNCHES,
            "masked_attn_fwd": mac.LAUNCHES}


def reset_kernel_counts() -> None:
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    msda_cuda.LAUNCHES = tw.LAUNCHES = mac.LAUNCHES = 0


@contextlib.contextmanager
def plain_ops():
    """Every kernel of the model replaced by its plain version; fails if a
    kernel is launched all the same."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import ms_deform_attn as msda_mod
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    before = kernel_counts()
    with mock.patch.object(msda_mod, "msda_fwd", msda_cuda.ms_deform_attn_plain), \
            mock.patch.object(tw, "tap_weight_fwd", tw.weight_taps_plain), \
            mock.patch.object(mac, "masked_attn_fwd", mac.masked_attention_plain):
        yield
    if kernel_counts() != before:
        raise AssertionError("the plain-op forward launched a kernel")


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
                     {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, card, 3)
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
        {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, warm_passes=2)
    route = phase_tap_weighting_route(torch, card, predictor1, images[0], canvas, k1_out)
    phase_eval(torch, card, cfg2, predictor2)
    by_path = {"slice": s1, "slice2": s2, "tap_weighting_route": route}
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
