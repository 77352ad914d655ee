"""Swin Transformer backbone, registered as `D2SwinTransformer`
(`mp_former_tpu/models/backbone/swin.py`, reference
modeling/backbone/swin.py:1-770).

NCHW in and NCHW out (res2..res5), like the port's ResNet; inside, tokens
(B, H*W, C) and NHWC where the windows are cut, as the JAX package computes.
Window padding, shift masks and relative-position indices are numpy, made at
construction (the index, a non-persistent buffer) or once per padded grid
(the masks, cached on the module). The qkv projection stays packed, so the
state-dict names are the reference's d2 names: `patch_embed.{proj,norm}`,
`layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}`,
`layers.{i}.downsample.{norm,reduction}`, `norm{i}`, `absolute_pos_embed`
((1, C, g, g)); `relative_position_index` is computed, not stored.

Window attention is plain torch ops mirroring the JAX package's XLA
(`swin.py:83-97`: a product, the bias, the -100 shift mask, softmax, a
product), not a kernel. Its types under `TPU.COMPUTE_DTYPE bfloat16` are the
JAX package's: q k^T in bfloat16, the float32 bias table promotes the logits
to float32, and the weights times v runs in float32 (JAX promotes the
bfloat16 v); LayerNorms, linears and the residual stream are bfloat16.

Three behaviours follow the JAX package where it departs from the reference
(ROADMAP §C, pinned by tests/test_torch_swin.py):
- drop path fires only with `forward(x, train=True)`, and `MaskFormer.forward`
  calls the backbone without it (JAX `maskformer.py:90`), so the recipes'
  DROP_PATH_RATE trains nothing, here as there (and the model's `.eval()`
  mode changes nothing);
- the absolute position embedding's grid is 224 / PATCH_SIZE:
  `MODEL.SWIN.PRETRAIN_IMG_SIZE` is not read (JAX `build_swin_backbone`);
- `MODEL.BACKBONE.FREEZE_AT` reaches the backbone through the optimizer
  (`engine/optimizer.py:freeze_backbone`), not through the module.
`MODEL.SWIN.USE_CHECKPOINT` recomputes each block in the backward
(`torch.utils.checkpoint`, the JAX package's `nn.remat`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ...utils import float32_region
from ...utils.layers import LayerNorm
from ...utils.shape_spec import ShapeSpec

# the absolute position embedding's pretraining image size: the JAX package's
# build_swin_backbone does not pass MODEL.SWIN.PRETRAIN_IMG_SIZE, so its default holds
APE_PRETRAIN_SIZE = 224


def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) index into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) additive mask (0 / -100) of the shifted windows."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.view(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(...,
    method="cubic")` along one axis (jax/_src/image/scale.py:
    compute_weight_mat): Keys' cubic kernel with a = -0.5 (torch's bicubic
    takes -0.75), widened by the scale where it shrinks (antialiasing), each
    output's weights divided by their sum, in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_cubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, *size) as `jax.image.resize(..., "cubic")`
    resizes the last two axes, in float32; an axis of equal size is left as
    it is, as JAX leaves it."""
    with float32_region(x.device.type):
        x = x.float()
        for axis, n in ((2, size[0]), (3, size[1])):
            if x.shape[axis] != n:
                w = torch.from_numpy(cubic_resize_weights(x.shape[axis], n)).to(x.device)
                x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
        return x


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(window_size, window_size)).view(-1), persistent=False)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        bias = self.relative_position_bias_table[self.relative_position_index]
        # a float32 table promotes bfloat16 logits to float32, as in JAX
        attn = q @ k.transpose(-2, -1) + bias.view(n, n, h).permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            attn.view(b_ // nw, nw, h, n, n).add_(mask[None, :, None])
        attn = attn.softmax(-1)
        with float32_region(x.device.type):
            out = attn @ v.to(attn.dtype)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def _drop_path(y: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """`keep`: (B, 1, 1) of 0 or 1/keep_prob, drawn outside the block (so a
    recomputed block sees the same draw), or None."""
    return y if keep is None else y * keep.to(y.dtype)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale: Optional[float],
                 drop_path: float):
        super().__init__()
        self.window_size, self.shift_size, self.drop_path = window_size, shift_size, drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], attn_mask: torch.Tensor,
                keep: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)
                ) -> torch.Tensor:
        """x (B, H*W, C); `attn_mask` the shift mask of the padded grid (used
        by the shifted blocks); `keep` the drop-path factors of both branches."""
        (h, w), ws, shift = hw, self.window_size, self.shift_size
        b, _, c = x.shape
        shortcut = x
        x = self.norm1(x).view(b, h, w, c)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        x = self.attn(window_partition(x, ws), attn_mask if shift > 0 else None)
        x = window_reverse(x, ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = x[:, :h, :w].reshape(b, h * w, c)
        x = shortcut + _drop_path(x, keep[0])
        return x + _drop_path(self.mlp(self.norm2(x)), keep[1])


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.view(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1).view(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if patch_norm else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """(B, 3, H, W) -> tokens (B, H/p * W/p, C) and the grid's H/p, W/p."""
        x = self.proj(x)
        h, w = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        return (x if self.norm is None else self.norm(x)), h, w


class BasicLayer(nn.Module):
    """One stage: its blocks, then the patch merging into the next stage."""

    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Reference SwinTransformer (:498-683) with the d2 wrapper's per-stage
    output norms and `output_shape` (:686-770)."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.3,
                 patch_norm: bool = True, ape: bool = False,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 use_checkpoint: bool = False):
        super().__init__()
        self.embed_dim, self.window_size = embed_dim, window_size
        self.out_features = tuple(out_features)
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbed(patch_size, embed_dim, patch_norm)
        if ape:
            g = APE_PRETRAIN_SIZE // patch_size
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, g, g))
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02)
        else:
            self.absolute_pos_embed = None
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        layers, dim, first = [], embed_dim, 0
        for i, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[i], window_size,
                                0 if j % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                                qk_scale, float(dpr[first + j])) for j in range(depth)]
            first += depth
            layers.append(BasicLayer(blocks, PatchMerging(dim) if i < len(depths) - 1 else None))
            dim *= 2
        self.layers = nn.ModuleList(layers)
        self.out_indices = sorted(int(f[3:]) - 2 for f in self.out_features)
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))
        self.apply(_init_weights)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _shift_mask(self, h: int, w: int, device) -> torch.Tensor:
        ws = self.window_size
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        key = (hp, wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_attn_mask(hp, wp, ws, ws // 2)).to(device)
        return self._masks[key]

    def _keep(self, block: SwinBlock, b: int, train: bool, generator, device):
        """The drop-path factors of a block's two branches (JAX `swin.py:147-153`:
        a Bernoulli draw a sample, scaled by 1 / keep), or None."""
        if block.drop_path == 0.0 or not train:
            return (None, None)
        keep = 1.0 - block.drop_path
        return tuple((torch.rand((b, 1, 1), generator=generator, device=device) < keep).float()
                     / keep for _ in range(2))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) -> {res2..res5: (B, C_i, H / 2^(i+2), W / 2^(i+2))}.
        `train` switches drop path on, drawn from `generator`; `MaskFormer`
        never passes it (module docstring)."""
        x, h, w = self.patch_embed(x)
        b = x.shape[0]
        if self.absolute_pos_embed is not None:
            ape = resize_cubic(self.absolute_pos_embed, (h, w)).to(x.dtype)
            x = x + ape.flatten(2).transpose(1, 2)
        outs = {}
        dim = self.embed_dim
        for i, layer in enumerate(self.layers):
            mask = self._shift_mask(h, w, x.device)
            for blk in layer.blocks:
                keep = self._keep(blk, b, train, generator, x.device)
                if self.use_checkpoint and torch.is_grad_enabled():
                    x = ckpt.checkpoint(blk, x, (h, w), mask, keep, use_reentrant=False)
                else:
                    x = blk(x, (h, w), mask, keep)
            if i in self.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs[f"res{i + 2}"] = y.view(b, h, w, dim).permute(0, 3, 1, 2).contiguous()
            if layer.downsample is not None:
                x = layer.downsample(x, h, w)
                h, w, dim = (h + 1) // 2, (w + 1) // 2, dim * 2
        return outs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {f: ShapeSpec(channels=self.embed_dim * 2 ** (int(f[3:]) - 2),
                             stride=2 ** int(f[3:]))
                for f in self.out_features}


def _init_weights(m: nn.Module) -> None:
    """The reference's `_init_weights`: linears truncated normal (std 0.02),
    biases 0, LayerNorms 1 and 0; the patch projection keeps torch's init."""
    if isinstance(m, nn.Linear):
        nn.init.trunc_normal_(m.weight, std=0.02)
        if m.bias is not None:
            nn.init.zeros_(m.bias)
    elif isinstance(m, nn.LayerNorm):
        nn.init.ones_(m.weight)
        nn.init.zeros_(m.bias)


def build_swin_backbone(cfg) -> SwinTransformer:
    s = cfg.MODEL.SWIN
    return SwinTransformer(
        patch_size=s.PATCH_SIZE,
        embed_dim=s.EMBED_DIM,
        depths=tuple(s.DEPTHS),
        num_heads=tuple(s.NUM_HEADS),
        window_size=s.WINDOW_SIZE,
        mlp_ratio=s.MLP_RATIO,
        qkv_bias=s.QKV_BIAS,
        qk_scale=s.QK_SCALE,
        drop_path_rate=s.DROP_PATH_RATE,
        patch_norm=s.PATCH_NORM,
        ape=s.APE,
        out_features=tuple(s.OUT_FEATURES),
        use_checkpoint=s.USE_CHECKPOINT,
    )
