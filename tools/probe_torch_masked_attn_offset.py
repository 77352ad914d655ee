#!/usr/bin/env python3
"""K3's float32 accuracy where the decoder's features lead it astray, and its
time, on one CUDA card.

    python3 tools/probe_torch_masked_attn_offset.py [--repo DIR] [--seed 0]

The decoder's cross-attention spreads a query's weight over thousands of keys
whose values share an offset (v ~ 3 + 0.25 N(0, 1), the features of the
Swin-L recipe's step). There a sum over the keys that rounds the same way at
every add drifts with S. At B4 H8 Q200 D32 and S = 1024, 4096, 16384 (the
Swin-L recipe's training levels) the tool holds, against float64:

  kernel      the port's K3 (`csrc/masked_attn_fwd.cu` of `--repo`'s package);
  plain       `masked_attention_plain` in float32;
  tiled       `masked_attention_tiled`, the kernel's arithmetic in PyTorch;

each as the largest error over max(1, the largest output entry). Then the
kernel's device time (CUDA graph replay) at `chip_smoke.py` phase K3's shapes
(B1 H8, Q = 100 and 200, S = 850, 3400, 13600, float32 and bfloat16), so that
two trees can be compared in one call: `--repo` puts that directory's
`mp_former_tpu_torch` first on the path (e.g. a `git archive` of the parent
unpacked under `output/`), and its kernels are built there. One JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 8, 200, 32)
KEYS = (1024, 4096, 16384)
PHASE_K3 = [(Q, S) for Q in (100, 200) for S in (850, 3400, 13600)]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO, help="the tree whose port is measured")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_masked_attn_offset: needs a CUDA card")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.utils.cuda_timing import card_string, device_ms

    if not mac.__file__.startswith(repo):
        raise SystemExit(f"the port was imported from {mac.__file__}, not from {repo}")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    B, H, Q, D = SHAPE
    result = {"card": card_string(), "repo": os.path.relpath(repo, REPO),
              "errors_vs_float64": {}, "ms": {}}
    for S in KEYS:
        q = 0.3 * torch.randn((B, H, Q, D), generator=g, device="cuda")
        k = torch.randn((B, H, S, D), generator=g, device="cuda")
        v = 3.0 + 0.25 * torch.randn((B, H, S, D), generator=g, device="cuda")
        mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.1
        logits = torch.einsum("bhqd,bhsd->bhqs", q.double(), k.double()) / D ** 0.5
        exact = torch.einsum("bhqs,bhsd->bhqd",
                             logits.masked_fill_(mask[:, None], -1e9).softmax(-1), v.double())
        del logits
        scale = exact.abs().max().clamp(min=1.0)
        result["errors_vs_float64"][f"B{B}xH{H}xQ{Q}xS{S}xD{D}"] = {
            name: ((fn(q, k, v, mask).double() - exact).abs().max() / scale).item()
            for name, fn in (("kernel", mac.masked_attn_fwd),
                             ("plain", mac.masked_attention_plain),
                             ("tiled", mac.masked_attention_tiled))}
        del exact
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for Q, S in PHASE_K3:
            q, k, v = (torch.randn((1, n, H * D), generator=g, device="cuda").to(dtype)
                       .view(1, n, H, D).transpose(1, 2) for n in (Q, S, S))
            mask = torch.rand((1, Q, S), generator=g, device="cuda") < 0.7
            result["ms"][f"{name} B1xH{H}xQ{Q}xS{S}xD{D}"] = device_ms(
                lambda: mac.masked_attn_fwd(q, k, v, mask))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
