"""Requests through the port's `Predictor.__call__`, one client in a closed
loop: each request is sent when the last one's host arrays are back.

The requests are seeded uint8 BGR images, their sizes a fixed mix (`sizes`,
width x height) in a fresh seeded order in every block of as many requests,
so every seed sends the same work in another order; the images come from a
pool of `variants` an size. Set-up builds the predictor with the
benchmark's seeded weights and serves one image of each size. The window's
end-to-end metrics: `serve_images_per_s`, the requests completed over the
whole window, the last one's return included; `serve_p95_ms`, the 95th
percentile of all its requests' latencies, each from its call to its return;
`peak_gib`, the allocator's peak over the window; `setup_s`.

`correct` (once the window has closed and the predictor is freed): a sample
of the completed requests drawn from the seed, with the first of the largest
size in it, is served again by the reference (`reference/`, float32 with
TF32 off, the same weights), and each of the port's detections is judged
against it. A detection's query is the reference query whose binary mask
overlaps the port's mask best, the closest score among near ties; its gap
is that between the port's score and the score the reference gives that
(query, class). The numbers of a request (`NUMBERS`): the worst, the median
and the 90th percentile of the detections' gaps, absolute or relative to the
reference's score (`score_gap`, `score_rel_gap`, `score_rel_median`,
`score_rel_p90`); the worst, median and mean share of the image's pixels on
which the two masks disagree (`mask_gap*`); the worst detection's 1 - IoU of
the two masks (`mask_iou_gap`), and the same pooled over the request's
detections, the disagreeing pixels over the union's (`mask_pooled_gap`); the worst gap between the
port's and the reference's sorted top-k scores, each side's top-k by class
probability (`topk_gap`, `topk_rel_gap`); and the detections whose score is
off by more than half of the reference's (`wrong_answers`). Each is the
worst over the judged requests; those the cell's `limits` name are
compared."""

from __future__ import annotations

import json
import statistics
from typing import Dict, List

import numpy as np
import torch

from .. import common, data
from ..spec import Check, Outcome

# the numbers of a judged request, each the worst over the judged requests;
# those the cell's `limits` name are compared
NUMBERS = ("score_gap", "score_rel_gap", "score_rel_median", "score_rel_p90", "mask_gap",
           "mask_gap_median", "mask_gap_mean", "mask_iou_gap", "mask_pooled_gap", "topk_gap",
           "topk_rel_gap", "wrong_answers")


def request_order(seed: int, count: int, kinds: int) -> List[int]:
    """`count` indices into `kinds`, each block of `kinds` a permutation."""
    rng = np.random.RandomState((seed + 1) % 2 ** 32)
    out: List[int] = []
    while len(out) < count:
        out.extend(int(i) for i in rng.permutation(kinds))
    return out[:count]


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by `statistics.quantiles(method="inclusive")`."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1]


def canvas_pixels(cfg, w: int, h: int) -> int:
    """The padded canvas's pixels of a w x h request (`preprocess_image`'s rule)."""
    scale = cfg.INPUT.MIN_SIZE_TEST / min(h, w)
    if max(h, w) * scale > cfg.INPUT.MAX_SIZE_TEST:
        scale = cfg.INPUT.MAX_SIZE_TEST / max(h, w)
    rh, rw = int(h * scale + 0.5), int(w * scale + 0.5)
    return ((rh + 31) // 32 * 32) * ((rw + 31) // 32 * 32)


def _serving(cell, predictor):
    """What the window calls: the predictor, or under a fault that the tests
    and the calibration plant (`variant`) the predictor with one detection's
    class altered, or every mask shifted by one pixel, where it is produced."""
    if cell.variant not in ("fault:answer", "fault:mask_shift"):
        return predictor

    def altered(image):
        out = predictor(image)
        inst = out["instances"]
        if cell.variant == "fault:answer":
            classes = inst["classes"].copy()
            classes[0] = (classes[0] + 1) % 80
            inst["classes"] = classes
        else:
            inst["masks"] = np.roll(inst["masks"], 1, axis=-1)
        return out

    return altered


def _judge(program: Dict, logits, masks, image_size, hw, topk: int, device) -> Dict[str, float]:
    """The numbers of one judged request (`NUMBERS`)."""
    from ..reference import serve

    h, w = hw
    out = serve.masks_at_output(masks, image_size, h, w)
    ref_scores = serve.instance_scores(logits, out)                    # (Q, K)
    ref_bin = (out > 0).flatten(1).float()                             # (Q, HW)
    inst = program["instances"]
    p_bin = torch.from_numpy(inst["masks"]).to(device).flatten(1).float()
    scores = torch.from_numpy(inst["scores"]).to(device).double()
    classes = torch.from_numpy(inst["classes"]).to(device).long()
    inter = p_bin @ ref_bin.T                                          # (k, Q)
    union = p_bin.sum(1, keepdim=True) + ref_bin.sum(1)[None] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1), torch.ones_like(inter))
    cand = ref_scores.double().T[classes]                              # (k, Q)
    # the best-overlapping queries, the closest score among near ties
    near = iou >= iou.max(1, keepdim=True)[0] - 1e-6
    gap = torch.where(near, (cand - scores[:, None]).abs(), torch.full_like(cand, float("inf")))
    q = gap.argmin(1)
    score_abs = gap.gather(1, q[:, None])[:, 0]
    ref_s = cand.gather(1, q[:, None])[:, 0]
    score_rel = score_abs / ref_s.clamp(min=1e-12)
    diff = (p_bin - ref_bin[q]).abs().sum(1)
    disagree = diff / p_bin.shape[1]
    matched_union = (p_bin.sum(1) + ref_bin[q].sum(1) + diff) / 2
    iou_gap = torch.where(matched_union > 0, diff / matched_union.clamp(min=1),
                          torch.zeros_like(diff))
    # the reference's own top-k by class probability, then times the mask scores
    top = logits.softmax(-1)[:, :-1].flatten().topk(topk)[1]
    ref_top = ref_scores.flatten()[top].double().sort(descending=True)[0]
    mine = scores.sort(descending=True)[0]
    return {"score_gap": float(score_abs.max()),
            "score_rel_gap": float(score_rel.max()),
            "score_rel_median": float(score_rel.median()),
            "score_rel_p90": float(score_rel.quantile(0.9)),
            "mask_gap": float(disagree.max()),
            "mask_gap_median": float(disagree.median()),
            "mask_gap_mean": float(disagree.mean()),
            "mask_iou_gap": float(iou_gap.max()),
            "mask_pooled_gap": float(diff.sum() / matched_union.sum().clamp(min=1)),
            "topk_gap": float((mine - ref_top).abs().max()),
            "topk_rel_gap": float(((mine - ref_top).abs() / ref_top.clamp(min=1e-12)).max()),
            "wrong_answers": float((score_rel > 0.5).sum())}


def run(cell) -> Outcome:
    p = cell.params
    device = torch.device(cell.device)
    extra = ["TPU.COMPUTE_DTYPE", "bfloat16"] if cell.variant == "control" else []
    cfg = cell.program_cfg(extra)
    from mp_former_tpu_torch.engine.predictor import Predictor

    sizes = [tuple(s) for s in p["sizes"]]
    variants = int(p["variants"])
    num_classes = int(cell.config["cfg"]["MODEL"]["SEM_SEG_HEAD"]["NUM_CLASSES"])
    model = common.program_model(cell, cfg, device)
    predictor = Predictor(cfg, model=model, device=device, is_thing=np.ones(num_classes, bool))
    del model
    serve_fn = _serving(cell, predictor)
    images = {}
    for k, (w, h) in enumerate(sizes):
        images[k] = data.request_images(cell.seed * 31 + k, variants, [(w, h)])
    variant_rng = np.random.RandomState((cell.seed + 2) % 2 ** 32)
    order = request_order(cell.seed, int(p["max_requests"]), len(sizes))
    pick = [int(v) for v in variant_rng.randint(0, variants, len(order))]

    # set-up: one request of each size
    for k in range(len(sizes)):
        serve_fn(images[k][0])
    common.sync(device)
    setup_s = common.now() - cell.t0

    # the sample that the reference judges: a seeded reservoir, and the first
    # request of the largest size
    largest = max(range(len(sizes)), key=lambda k: canvas_pixels(cfg, *sizes[k]))
    sample_rng = np.random.RandomState((cell.seed + 3) % 2 ** 32)
    keep = int(p["checked"])
    kept: Dict[int, Dict] = {}
    first_largest = None

    instruments = common.Instruments(cell.trace, int(p["profile_skip"]), int(p["profile_device"]),
                                     int(p["profile_ranges"]), device.type)
    if cell.trace:
        net = predictor.model
        instruments.wrap_methods({
            "backbone": (net.backbone, "forward"),
            "pixel_decoder": (net.sem_seg_head.pixel_decoder, "forward_features"),
            "decoder": (net.sem_seg_head.predictor, "forward")})
        forward_raw = predictor.forward_raw
        returned = []

        def timed_forward(*a, **k):
            out = forward_raw(*a, **k)
            returned.append(common.now())
            return out

        predictor.forward_raw = timed_forward
    device_sizes: List[int] = []
    latencies: List[float] = []
    common.peak_reset(device)
    instruments.start()
    t_start = common.now()
    n = 0
    while n < len(order):
        k = order[n]
        image = images[k][pick[n]]
        if instruments.phase == "device":
            device_sizes.append(k)
        t0 = common.now()
        out = serve_fn(image)
        t1 = common.now()
        latencies.append(t1 - t0)
        if cell.trace:
            instruments.add_span("postprocess_s", t1 - returned[-1])
        # reservoir sampling of `keep` requests
        if n < keep:
            kept[n] = out
        else:
            j = int(sample_rng.randint(0, n + 1))
            if j < keep:
                victim = sorted(kept)[j]
                del kept[victim]
                kept[n] = out
        if k == largest and first_largest is None:
            first_largest = (n, out)
        n += 1
        instruments.step()
        if t1 - t_start >= cell.seconds:
            break
    common.sync(device)
    t_end = common.now()
    instruments.close()
    peak = common.peak_bytes(device)
    if first_largest is not None:
        kept[first_largest[0]] = first_largest[1]
    readings = instruments.readings
    if readings is not None:
        # a unit the window's end cut short is not one of the stretch's
        device_sizes = device_sizes[:readings.device_units]
    del predictor, serve_fn
    common.free(device)

    # the reference serves the sample again
    from .. import flops
    from ..reference import serve

    rcfg = cell.reference_cfg()
    gaps = []
    # no_grad, not inference_mode: the FLOP counter's dispatch mode sees no op
    # under inference_mode
    with common.float32_exact(), torch.no_grad():
        ref = common.reference_model(cell, device)
        for idx, prog in sorted(kept.items()):
            image = images[order[idx]][pick[idx]]
            canvas, image_size = serve.preprocess_image(rcfg, image, device)
            o = ref(canvas)
            gaps.append(_judge(prog, o["pred_logits"][0].float(), o["pred_masks"][0].float(),
                               image_size, image.shape[:2], int(rcfg.TEST.DETECTIONS_PER_IMAGE),
                               device))
        if readings is not None and readings.device_units:
            per_size = {}
            for k in set(device_sizes):
                canvas, _ = serve.preprocess_image(rcfg, images[k][0], device)
                with flops.FlopCount() as counter:
                    ref(canvas)
                per_size[k] = sum(counter.by_family().values())
            readings.flops = sum(per_size[k] for k in device_sizes)
    del ref
    common.free(device)
    numbers = {k: max(g[k] for g in gaps) if gaps else float("inf") for k in NUMBERS}
    checks = [Check(k, numbers[k], limit) for k, limit in cell.workload["limits"].items()]
    print("port_bench: numbers " + json.dumps(numbers), flush=True)
    lat_ms = sorted(x * 1e3 for x in latencies)
    print(f"port_bench: {n} requests in {t_end - t_start:.4f} s; latency median "
          f"{statistics.median(lat_ms):.4f} ms, p95 {percentile(lat_ms, 95):.4f} ms over "
          f"{len(lat_ms)} requests; {len(gaps)} requests judged", flush=True)
    if readings is not None:
        print(f"port_bench: seconds a request by what profiled it: {readings.pace()}", flush=True)
    metrics = {"setup_s": (setup_s, "s"),
               "serve_images_per_s": (n / (t_end - t_start), "images/s"),
               "serve_p95_ms": (percentile(lat_ms, 95), "ms"),
               "peak_gib": (peak / 2 ** 30, "GiB")}
    return Outcome(n, 0, metrics, common.device_fields(device, peak, cell.chips), checks,
                   readings, numbers)
