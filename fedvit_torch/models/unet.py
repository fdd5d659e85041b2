"""Attention U-Net segmentation branch of the old generation
(``fedvit_tpu/models/unet.py``; reference segmentation.py:23-270).

NHWC throughout, as in the JAX package, and JAX's module names:
``encoder.enc{i}``, ``encoder.bottleneck``, ``decoder.up{i}``,
``decoder.attn{i}``, ``decoder.dec{i}`` and ``decoder.final_conv``, with
torch's leaf names (``weight``, ``bias``, ``running_mean``, ``running_var``).

No Pallas kernel is on this path in JAX: the convolutions are
``F.conv2d``/``F.conv_transpose2d`` on NHWC tensors viewed as channels-last
NCHW, the pools ``F.max_pool2d`` (floors odd sizes, as flax's VALID pool),
the upsampling ``ops/image.py::resize(method="linear")``.

Weights are fp32 and cast to the compute dtype at use, as flax's ``dtype``;
the BatchNorms compute and return fp32 (``FlaxBatchNorm``), so the blocks'
outputs are fp32, as JAX's are.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fedvit_torch.ops.image import resize
from fedvit_torch.parallel import data as data_parallel


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the NCHW view of it (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` on NHWC input: weight (out, in, kh, kw), input,
    weight and bias cast to ``dtype``, symmetric ``padding``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.padding = padding
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dt).contiguous(memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        return _nhwc(F.conv2d(_nchw(x.to(dt)), w, b, padding=self.padding))


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel = stride = k, ``padding="SAME"``
    and ``transpose_kernel=False`` on NHWC input. Its weight is torch's
    (in, out, k, k) layout of flax's kernel flipped in both spatial axes
    (flax correlates where ``F.conv_transpose2d`` convolves); the flip is
    made when the weights are imported (``import_weights.py``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = k
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dt).contiguous(memory_format=torch.channels_last)
        return _nhwc(F.conv_transpose2d(_nchw(x.to(dt)), w, self.bias.to(dt),
                                        stride=self.stride))


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, dtype=float32)`` over every axis but
    the last: fp32 statistics and output, the fast variance
    max(E[x²] − E[x]², 0), epsilon 1e-5. Training normalises with the batch
    statistics and moves the running mean and the *biased* running variance
    as 0.9·r + 0.1·s (torch's BatchNorm keeps the unbiased one, which is why
    this is not ``TorchBatchNorm``); evaluation uses the running statistics.
    Its buffers are ``running_mean`` and ``running_var`` alone. Inside a
    data-parallel SPMD step the moments are the whole micro-batch's
    (``parallel/data.py``)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            axes = tuple(range(x32.dim() - 1))
            rows = data_parallel.rows()
            if rows is None:
                mean = x32.mean(axes)
                mean_sq = (x32 * x32).mean(axes)
            else:
                # the whole micro-batch's moments: both sums in one
                # all-reduce over the data group, with autograd
                own = x32[:rows.valid]
                count = rows.n * (x32[0].numel() // x32.shape[-1])
                sums = data_parallel.all_reduce_sum(
                    torch.cat([own.sum(axes), (own * own).sum(axes)]),
                    rows.group) / count
                mean, mean_sq = sums.chunk(2)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x32 - mean) * mul + self.bias


class ConvBlock(nn.Module):
    """(3×3 conv → BatchNorm → ReLU) × 2, the convs without bias
    (reference segmentation.py:23-44)."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, 1, False, dtype)
        self.bn1 = FlaxBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, False, dtype)
        self.bn2 = FlaxBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` to (h, w), in x's dtype."""
    if x.shape[1:3] == (h, w):
        return x
    return resize(x, (h, w), "linear").to(x.dtype)


class AttentionGate(nn.Module):
    """Spatial attention gate (reference segmentation.py:47-104): the gate
    resized to the skip's size, 1×1 convs W_g and W_x with BatchNorms,
    ReLU of their sum, a 1×1 conv to one channel, BatchNorm, sigmoid; the
    skip times that map."""

    def __init__(self, gate_ch: int, skip_ch: int, inter: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.W_g = Conv2d(gate_ch, inter, 1, 0, False, dtype)
        self.bn_g = FlaxBatchNorm(inter)
        self.W_x = Conv2d(skip_ch, inter, 1, 0, False, dtype)
        self.bn_x = FlaxBatchNorm(inter)
        self.psi = Conv2d(inter, 1, 1, 0, False, dtype)
        self.bn_psi = FlaxBatchNorm(1)

    def forward(self, gate: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        gate = _resize_to(gate, skip.shape[1], skip.shape[2])
        psi = torch.relu(self.bn_g(self.W_g(gate)) + self.bn_x(self.W_x(skip)))
        psi = torch.sigmoid(self.bn_psi(self.psi(psi)))
        return skip * psi


class UNetEncoder(nn.Module):
    """Four ConvBlocks, each followed by a 2×2 max pool, then the bottleneck
    at twice the last width (reference segmentation.py:111-151). Returns
    (the blocks' outputs, the bottleneck)."""

    def __init__(self, in_ch: int, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_ch, *channels]
        for i, ch in enumerate(channels):
            self.add_module(f"enc{i}", ConvBlock(widths[i], ch, dtype))
        self.bottleneck = ConvBlock(channels[-1], channels[-1] * 2, dtype)
        self.depth = len(channels)

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feats = []
        for i in range(self.depth):
            x = getattr(self, f"enc{i}")(x)
            feats.append(x)
            x = _nhwc(F.max_pool2d(_nchw(x), 2, 2))
        return feats, self.bottleneck(x)


class AttentionUNetDecoder(nn.Module):
    """Per level: a 2×2 stride-2 transposed conv, resized to the skip's size
    where the encoder floored an odd one, the attention-gated skip
    concatenated, a ConvBlock; then a 1×1 conv to the one-channel mask
    (reference segmentation.py:158-232). Returns (mask logits fp32, the
    blocks' outputs)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        enc_rev = list(reversed(list(encoder_channels)))
        in_ch = encoder_channels[-1] * 2
        for i, (enc_ch, dec_ch) in enumerate(zip(enc_rev, decoder_channels)):
            self.add_module(f"up{i}", ConvTranspose2d(in_ch, dec_ch, 2, dtype))
            self.add_module(f"attn{i}", AttentionGate(
                dec_ch, enc_ch, max(1, enc_ch // 2), dtype))
            self.add_module(f"dec{i}", ConvBlock(dec_ch + enc_ch, dec_ch, dtype))
            in_ch = dec_ch
        self.final_conv = Conv2d(in_ch, 1, 1, 0, True, dtype)
        self.depth = min(len(enc_rev), len(decoder_channels))

    def forward(self, enc_feats: List[torch.Tensor], bottleneck: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        enc_rev = list(reversed(enc_feats))
        dec_feats = []
        x = bottleneck
        for i in range(self.depth):
            x = getattr(self, f"up{i}")(x)
            skip = enc_rev[i]
            x = _resize_to(x, skip.shape[1], skip.shape[2])
            gated = getattr(self, f"attn{i}")(x, skip)
            x = torch.cat([x.float(), gated.float()], dim=-1)
            x = getattr(self, f"dec{i}")(x)
            dec_feats.append(x)
        return self.final_conv(x).float(), dec_feats


class SegmentationBranch(nn.Module):
    """The Attention U-Net (reference segmentation.py:239-270):
    forward(x (B, H, W, C)) → (mask logits (B, H, W, 1) fp32, the decoder's
    feature maps, the bottleneck). BatchNorm statistics follow the module's
    training mode."""

    def __init__(self, in_channels: int = 3,
                 encoder_channels: Sequence[int] = (64, 128, 256, 512),
                 decoder_channels: Sequence[int] = (256, 128, 64, 32),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder = UNetEncoder(in_channels, encoder_channels, dtype)
        self.decoder = AttentionUNetDecoder(encoder_channels, decoder_channels,
                                            dtype)

    def forward(self, x: torch.Tensor):
        enc_feats, bottleneck = self.encoder(x.to(self.compute_dtype))
        mask, dec_feats = self.decoder(enc_feats, bottleneck)
        return mask, dec_feats, bottleneck
