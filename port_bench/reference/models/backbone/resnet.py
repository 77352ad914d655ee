"""ResNet backbone in detectron2's layout (`mp_former_tpu/models/backbone/resnet.py`).

Basic stem (7x7/2 conv + FrozenBN + relu + 3x3/2 maxpool), bottleneck stages
res2-res5, stride on the 3x3 conv unless STRIDE_IN_1X1, FrozenBN (eps 1e-5)
everywhere. State-dict names are detectron2's (`stem.conv1.weight`,
`stem.conv1.norm.*`, `res2.0.conv1.weight`, ...), as inside the released
`model_final.pth`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.layers import Conv2d, c2_xavier_fill
from ...utils.shape_spec import ShapeSpec


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, all buffers
    (detectron2 FrozenBatchNorm2d). The float32 statistics promote a
    bfloat16 convolution's result to float32, as in the JAX package
    (`resnet.py:38-39`): the convolutions run in the compute type, the maps
    between them are float32."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features) - eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        shift = self.bias - self.running_mean * scale
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class BasicStem(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 7, stride=2, padding=3, bias=False,
                            norm=FrozenBatchNorm2d(out_channels))
        c2_xavier_fill(self.conv1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu_(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with FrozenBN, residual add."""

    def __init__(self, in_channels: int, out_channels: int, *, bottleneck_channels: int,
                 stride: int = 1, num_groups: int = 1, stride_in_1x1: bool = False,
                 dilation: int = 1):
        super().__init__()
        if in_channels != out_channels:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride=stride, bias=False,
                                   norm=FrozenBatchNorm2d(out_channels))
        else:
            self.shortcut = None
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=stride_1x1, bias=False,
                            norm=FrozenBatchNorm2d(bottleneck_channels))
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, stride=stride_3x3,
                            padding=dilation, bias=False, groups=num_groups, dilation=dilation,
                            norm=FrozenBatchNorm2d(bottleneck_channels))
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False,
                            norm=FrozenBatchNorm2d(out_channels))
        for layer in (self.conv1, self.conv2, self.conv3, self.shortcut):
            if layer is not None:
                c2_xavier_fill(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu_(self.conv1(x))
        out = F.relu_(self.conv2(out))
        out = self.conv3(out)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu_(out + shortcut)


_STAGE_BLOCKS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class ResNet(nn.Module):
    """NCHW ResNet; returns a dict of the requested res2..res5 maps."""

    def __init__(self, depth: int = 50, out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 stride_in_1x1: bool = False, num_groups: int = 1, width_per_group: int = 64,
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 res5_dilation: int = 1):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = BasicStem(3, stem_out_channels)
        bottleneck = num_groups * width_per_group
        in_ch, out_ch = stem_out_channels, res2_out_channels
        self.stage_names = []
        self._out_channels = {}
        for idx, nblocks in enumerate(_STAGE_BLOCKS[depth]):
            name = f"res{idx + 2}"
            dilation = res5_dilation if name == "res5" else 1
            first_stride = 1 if idx == 0 or dilation > 1 else 2
            blocks = []
            for b in range(nblocks):
                blocks.append(BottleneckBlock(
                    in_ch, out_ch, bottleneck_channels=bottleneck,
                    stride=first_stride if b == 0 else 1, num_groups=num_groups,
                    stride_in_1x1=stride_in_1x1, dilation=dilation))
                in_ch = out_ch
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            self._out_channels[name] = out_ch
            bottleneck *= 2
            out_ch *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.stem(x)
        feats = {}
        for name in self.stage_names:
            out = getattr(self, name)(out)
            if name in self.out_features:
                feats[name] = out
        return feats

    def output_shape(self) -> Dict[str, ShapeSpec]:
        strides = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}
        return {f: ShapeSpec(channels=self._out_channels[f], stride=strides[f])
                for f in self.out_features}


def build_resnet_backbone(cfg) -> ResNet:
    r = cfg.MODEL.RESNETS
    return ResNet(
        depth=r.DEPTH,
        out_features=tuple(r.OUT_FEATURES),
        stride_in_1x1=r.STRIDE_IN_1X1,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        res5_dilation=r.RES5_DILATION,
    )
