"""Shared model layers — the counterparts of ``fedvit_tpu/models/layers.py``.

Conventions kept from the JAX package: NHWC images, fp32 parameters with a
separate compute dtype (weights are cast at use, as flax does), and the
reference/timm parameter names so state dicts cross between the packages.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from fedvit_torch.ops.activations import GELU, gelu
from fedvit_torch.ops.attention import attention_from_qkvb
from fedvit_torch.ops.flash_attention import (flash_attention_qkv,
                                              flash_attention_qkvb,
                                              flash_attention_xqkv)
from fedvit_torch.ops.layer_norm import LayerNorm
from fedvit_torch.parallel import data as data_parallel

# the ViT's ``model.attention_impl`` values, JAX's: ``xla`` is JAX's named XLA
# composition, the plain attention on any device (no kernel)
VIT_ATTENTION_IMPLS = ("auto", "pallas", "packed", "mega", "xla")


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters computed in ``dtype`` (flax Dense
    semantics: input, weight and bias cast to the compute dtype); with
    ``bias=False`` it has no bias (EVA-02's ``k_proj``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class TorchBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the leading axis in fp32 with torch's running-statistics
    convention (``fedvit_tpu/models/layers.py::TorchBatchNorm``).

    Training normalises with the batch's mean and biased variance and moves
    the running mean and the *unbiased* running variance by momentum 0.1;
    the branch is written out because ``nn.BatchNorm1d`` refuses a batch of
    1 in training, which the JAX module takes (factor n / max(n - 1, 1)).
    Evaluation uses the running statistics. Inside a data-parallel SPMD step
    the mean and variance are the whole micro-batch's, their sums taken over
    the group with autograd (``parallel/data.py``)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if not self.training:
            return super().forward(x32)
        rows = data_parallel.rows()
        if rows is None:
            n = x32.shape[0]
            mean = x32.mean(0)
            var = ((x32 - mean) ** 2).mean(0)
        else:
            n = rows.n
            own = x32[:rows.valid]
            mean = data_parallel.all_reduce_sum(own.sum(0), rows.group) / n
            var = data_parallel.all_reduce_sum(((own - mean) ** 2).sum(0),
                                               rows.group) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class LayerNormF32(LayerNorm):
    """flax ``nn.LayerNorm(dtype=float32)`` (eps 1e-6): the input promoted to
    fp32 before the statistics, fp32 output, so the backward (K4 on the card)
    runs in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def _keep_mask(shape, keep: float, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    """Bernoulli(keep) mask drawn from the caller's generator — never the
    global one, so the train step's generator decides every mask. Inside a
    data-parallel SPMD step (``parallel/data.py``) the mask is drawn at the
    whole micro-batch's shape and the rank keeps its rows' part: the same
    masks as the unsharded step, and every rank's generator moves alike."""
    if generator is None:
        raise ValueError("dropout in training mode needs the step's "
                         "torch.Generator (pass generator=...)")
    rows = data_parallel.rows()
    if rows is None:
        return torch.rand(shape, generator=generator, device=device) < keep
    whole = torch.rand((rows.n,) + tuple(shape[1:]), generator=generator,
                       device=device)
    return whole[rows.held] < keep


class Dropout(nn.Module):
    """flax ``nn.Dropout``: x / keep where kept, else 0, with the mask drawn
    from the ``generator`` passed to ``forward``; the identity in evaluation
    or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if keep <= 0.0:
            return torch.zeros_like(x)
        mask = _keep_mask(x.shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth per sample (timm semantics: kept samples scaled by
    1 / keep), mask drawn from the ``generator`` passed to ``forward``; the
    identity in evaluation or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = _keep_mask(shape, keep, generator, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def remat_block(block: nn.Module, x: torch.Tensor,
                generator: Optional[torch.Generator], *extra) -> torch.Tensor:
    """``block(x, generator, *extra)`` rematerialised (flax ``nn.remat``): its
    activations are not kept for the backward, which runs the block's
    forward again to rebuild them.

    Non-reentrant checkpointing: the first forward runs with grad enabled,
    so the attention takes the same kernels as without remat, and what an
    autograd ``Function`` saves through ``ctx.save_for_backward`` is freed.
    The recomputation draws its dropout and drop-path masks from
    ``generator`` set back to its state before the first forward, then puts
    the generator's state as it stood back: the backward sees the forward's
    own masks and later draws are those of a run without remat, as flax
    replays the same rng key. Nothing is drawn from the global RNG, so its
    state is neither saved nor moved."""
    start = None if generator is None else generator.get_state()

    @contextlib.contextmanager
    def replay():
        if generator is None:          # no masks drawn: nothing to replay
            yield
            return
        now = generator.get_state()
        generator.set_state(start)
        try:
            yield
        finally:
            generator.set_state(now)

    return checkpoint.checkpoint(
        block, x, generator, *extra, use_reentrant=False,
        preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), replay()))


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor,
               generator: Optional[torch.Generator],
               remat: bool, *extra) -> torch.Tensor:
    """Each of ``blocks`` in turn, ``blk(x, generator, *extra)`` (``extra``:
    inputs every block shares, such as EVA-02's rotary table),
    rematerialised (``remat_block``) when ``remat`` is set and a gradient is
    being recorded in training; evaluation, TTA and serving never
    checkpoint."""
    remat = remat and blocks.training and torch.is_grad_enabled()
    for blk in blocks:
        x = (remat_block(blk, x, generator, *extra) if remat
             else blk(x, generator, *extra))
    return x


def run_sequential(layers: nn.Sequential, x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``nn.Sequential``'s forward, with the generator handed to each
    ``Dropout``."""
    for layer in layers:
        x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
    return x


class Mlp(nn.Module):
    """Transformer MLP: fc1 → GELU → fc2 (the ViT's dropout rate is 0.0,
    ``fedvit_tpu/models/vit.py:84``, so there is no dropout layer)."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class MultiHeadAttention(nn.Module):
    """The JAX package's MHA with its compositions of the ``qkv`` projection
    and the attention, chosen by ``attention_impl``; then ``proj``. The
    ``qkv`` parameters keep nn.Linear's (timm) layout in all of them, so the
    same weights load into each.

    - ``auto``, ``pallas``: a bias-free ``x @ W_qkv`` matmul, then
      ``flash_attention_qkvb`` with the projection bias applied inside the op
      (K1 without grad, K2/K3 with), so the bias gradient comes only from the
      attention's backward;
    - ``xla``: the same bias-free matmul, then ``ops/attention.py::
      attention_from_qkvb``, the plain attention (JAX's named XLA
      composition): no kernel on any device, and (B, H, N, N) fp32 scores
      in device memory;
    - ``packed``: the ``qkv`` Dense with its bias, in the compute dtype, then
      ``flash_attention_qkv`` (K10);
    - ``mega``: ``flash_attention_xqkv`` (K11) on x, W and the bias cast to
      the compute dtype: the projection runs inside the kernel, its products
      summed in fp32 with the bias and rounded once.

    Each kernel op runs its CUDA kernels on a GPU tensor and its plain
    version on a CPU tensor."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        if attention_impl not in VIT_ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl={attention_impl!r} is not one of the ViT's "
                f"{VIT_ATTENTION_IMPLS}")
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.attention_impl = attention_impl
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.attention_impl == "packed":
            out = flash_attention_qkv(self.qkv(x), self.num_heads)
        elif self.attention_impl == "mega":
            # the JAX kernel's (D, 3E) layout of nn.Linear's (3E, D) weight
            w = self.qkv.weight.to(dt).t().contiguous()
            out = flash_attention_xqkv(x.to(dt).contiguous(), w,
                                       self.qkv.bias.to(dt), self.num_heads)
        else:
            qkv = torch.matmul(x.to(dt), self.qkv.weight.to(dt).t())
            attend = (attention_from_qkvb if self.attention_impl == "xla"
                      else flash_attention_qkvb)
            out = attend(qkv, self.qkv.bias, self.num_heads)
        return self.proj(out)


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> torch.Tensor:
    """Truncated normal at ±2σ, the JAX package's trunc-normal(0.02) init."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


__all__ = ["Dense", "TorchBatchNorm", "LayerNormF32", "Dropout", "DropPath",
           "remat_block", "run_blocks", "run_sequential",
           "Mlp", "MultiHeadAttention", "GELU", "trunc_normal_",
           "VIT_ATTENTION_IMPLS"]
