"""ResNet-50 and Wide-ResNet-101-2 (counterpart of
``nezha_tpu/models/resnet.py``).

Batches arrive as the JAX package's, ``{"image": [B, H, W, 3] f32}``:
the model permutes them to NCHW once at its entry, in
``torch.channels_last`` memory (the same bytes; cuDNN's fast layout on
Hopper), and the whole net runs in that format. BatchNorm statistics are
fp32 under the bf16 policy, each block's last BatchNorm scale starts at
zero, the head starts at zero and the logits come out fp32, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.nn.layers import (BatchNorm, Conv2d, Linear,
                                       _generator, global_avg_pool,
                                       max_pool, resolve_device)
from nezha_tpu_torch.nn.remat import checkpoint
from nezha_tpu_torch.ops.activations import relu
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, with a projection shortcut when the
    channels or the stride change."""

    def __init__(self, in_ch: int, width: int, out_ch: int, stride: int,
                 policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(use_bias=False, policy=policy, generator=generator,
                  device=device)
        bn = dict(policy=policy, device=resolve_device(device, generator))
        self.conv1 = Conv2d(in_ch, width, 1, **kw)
        self.bn1 = BatchNorm(width, **bn)
        self.conv2 = Conv2d(width, width, 3, stride=stride, **kw)
        self.bn2 = BatchNorm(width, **bn)
        self.conv3 = Conv2d(width, out_ch, 1, **kw)
        self.bn3 = BatchNorm(out_ch, **bn)
        # Each block starts as the identity (the large-batch trick).
        with torch.no_grad():
            self.bn3.scale.zero_()
        self.needs_proj = in_ch != out_ch or stride != 1
        if self.needs_proj:
            self.proj = Conv2d(in_ch, out_ch, 1, stride=stride, **kw)
            self.proj_bn = BatchNorm(out_ch, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu(self.bn1(self.conv1(x)))
        y = relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = self.proj_bn(self.proj(x)) if self.needs_proj else x
        return relu(y + sc)


def _space_to_depth_stem(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7x7 stride-2 stem conv as a 4x4 stride-1 conv over 12
    channels, the JAX package's arithmetic in NCHW: space-to-depth by 2
    (channel order (u, v, c)), the ``[O, C, 7, 7]`` weight zero-padded to
    8x8 and folded the same way to ``[O, 4C, 4, 4]``, padding (1, 2) in
    place of SAME's (2, 3). The same dot products as the plain conv; the
    parameter keeps its 7x7 shape. Needs even H and W."""
    b, c, h, wd = x.shape
    # [b, c, i, u, j, v] -> [b, i, j, u, v, c]: NHWC bytes, channels_last.
    xs = x.reshape(b, c, h // 2, 2, wd // 2, 2).permute(0, 2, 4, 3, 5, 1)
    xs = xs.reshape(b, h // 2, wd // 2, 4 * c).permute(0, 3, 1, 2)
    out_ch = w.shape[0]
    wp = F.pad(w, (0, 1, 0, 1))
    # [o, c, alpha, u, beta, v] -> [o, u, v, c, alpha, beta]
    ws = wp.reshape(out_ch, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    ws = ws.reshape(out_ch, 4 * c, 4, 4)
    return F.conv2d(F.pad(xs, (1, 2, 1, 2)), ws)


class ResNet(nn.Module):
    """Bottleneck ResNet over NHWC image batches. ``width_factor=2`` gives
    the Wide-ResNets (inner width doubled, outputs unchanged).
    ``stem="s2d"`` runs the stem through :func:`_space_to_depth_stem`
    when H and W are even (the plain conv otherwise), ``"conv7"`` always
    the plain conv. ``remat=True`` keeps each bottleneck's input only in
    training and recomputes the bottleneck in the backward; its
    BatchNorm statistics are updated once, by the forward."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width_factor: int = 1, in_channels: int = 3,
                 stem: str = "conv7", remat: bool = False,
                 policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        g = _generator(generator, device)
        self.remat = remat
        self.stage_sizes = tuple(stage_sizes)
        self.stem = stem
        self.policy = policy
        self.stem_conv = Conv2d(in_channels, 64, 7, stride=2,
                                use_bias=False, policy=policy, generator=g)
        self.stem_bn = BatchNorm(64, policy=policy, device=g.device)
        blocks = []
        in_ch = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            base = 64 * 2 ** stage
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(Bottleneck(in_ch, base * width_factor,
                                         base * 4, stride, policy=policy,
                                         generator=g))
                in_ch = base * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = Linear(in_ch, num_classes, kernel_init=init_lib.zeros,
                           policy=policy, generator=g)

    def forward(self, batch) -> torch.Tensor:
        x = batch["image"] if isinstance(batch, dict) else batch
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if self.stem == "s2d" and x.shape[2] % 2 == 0 \
                and x.shape[3] % 2 == 0:
            x = _space_to_depth_stem(
                self.policy.cast_to_compute(x),
                self.policy.cast_to_compute(self.stem_conv.weight))
        else:
            x = self.stem_conv(x)
        x = max_pool(relu(self.stem_bn(x)), 3, 2, "SAME")
        remat = self.remat and self.training
        for block in self.blocks:
            x = checkpoint(block, x) if remat else block(x)
        return self.head(global_avg_pool(x)).float()


def resnet50(num_classes: int = 1000, stem: str = "conv7",
             remat: bool = False, policy: Policy = DEFAULT_POLICY,
             generator: Optional[torch.Generator] = None,
             device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes=num_classes, stem=stem,
                  remat=remat, policy=policy, generator=generator,
                  device=device)


def wide_resnet101(num_classes: int = 1000, stem: str = "conv7",
                   remat: bool = False, policy: Policy = DEFAULT_POLICY,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> ResNet:
    """Wide-ResNet-101-2 (bottleneck width x2)."""
    return ResNet((3, 4, 23, 3), num_classes=num_classes, width_factor=2,
                  stem=stem, remat=remat, policy=policy, generator=generator,
                  device=device)
