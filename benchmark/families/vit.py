"""ViT, in timm's ``vit_base_patch16_224`` layout: a class token and learned
position embeddings, pre-norm blocks of global attention with its qkv bias
and a GELU MLP, the class token (or the mean of the patches) after the last
norm as the feature.

Everything the harness knows of one architecture, found by the
configuration's ``model.family`` (``harness/manifest.py``): the backbone's
parameters, its reference forward, its operation counts and the names of
the program's attention kernels that run it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint

from benchmark.reference.models import (Params, Precision, drop,
                                        drop_path_rates, layer_norm, linear,
                                        linear_spec, mlp, norm_spec,
                                        patch_embed)

# the tiny size of the harness's CPU tests: the configuration it cuts, the
# program's backbone at that size, the image and canvas sides, the sizes
TINY = {"config": "vit-base-224", "backbone": "vit_tiny_patch16_224",
        "image_size": 32, "canvas": 48,
        "model": {"embed_dim": 192, "depth": 12, "num_heads": 3}}

# the program's attention kernels, by the regular expressions their device
# names match: K2 (the forward with its log-sum-exp) and K3 in training,
# K1 in serving
ATTENTION_KERNELS = {
    "train": (r"attn_fwd::fwd_kernel<[^>]*, true, true>",
              r"attn_bwd::delta_kernel<",
              r"attn_bwd::(dkdv|dq)(_mma)?_kernel<[^>]*, true, true>",
              r"column_sum_kernel<"),
    "serve": (r"attn_fwd::fwd_kernel<[^>]*, true, false>",),
}

# a drop-path mask's shape after the batch: one per image over (tokens, D)
DROP_PATH_SHAPE = (1, 1)


def feature_dim(arch: Dict) -> int:
    return arch["embed_dim"]


def block_names(arch: Dict) -> List[str]:
    return [f"backbone.blocks.{i}" for i in range(arch["depth"])]


def backbone_spec(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    cin, patch, d0 = arch["in_chans"], arch["patch_size"], arch["embed_dim"]
    r = arch["mlp_ratio"]
    n = (arch["image_size"] // patch) ** 2 + 1
    spec = [("backbone.patch_embed.proj.weight", (d0, cin, patch, patch)),
            ("backbone.patch_embed.proj.bias", (d0,)),
            ("backbone.cls_token", (1, 1, d0)),
            ("backbone.pos_embed", (1, n, d0))]
    for blk in block_names(arch):
        spec += norm_spec(f"{blk}.norm1", d0)
        spec += linear_spec(f"{blk}.attn.qkv", d0, 3 * d0)
        spec += linear_spec(f"{blk}.attn.proj", d0, d0)
        spec += norm_spec(f"{blk}.norm2", d0)
        spec += linear_spec(f"{blk}.mlp.fc1", d0, int(d0 * r))
        spec += linear_spec(f"{blk}.mlp.fc2", int(d0 * r), d0)
    return spec + norm_spec("backbone.norm", feature_dim(arch))


def attention(x: torch.Tensor, p: Params, name: str, heads: int,
              prec: Precision) -> torch.Tensor:
    b, n, d = x.shape
    qkv = linear(x, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"], prec)
    q, k, v = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    scores = prec.out(prec(q) @ prec(k).transpose(-2, -1)) * (d // heads) ** -0.5
    out = prec.out(prec(torch.softmax(scores, -1)) @ prec(v))
    out = out.transpose(1, 2).reshape(b, n, d)
    return linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], prec)


def features(img: torch.Tensor, p: Params, arch: Dict,
             masks: Dict[str, Optional[torch.Tensor]], prec: Precision,
             remat: bool) -> torch.Tensor:
    eps = arch["ln_eps"]
    heads = arch["num_heads"]
    x = patch_embed(img, p, "backbone.patch_embed", arch["patch_size"], prec)
    b = x.shape[0]
    x = x.reshape(b, -1, x.shape[-1])
    x = torch.cat([p["backbone.cls_token"].expand(b, -1, -1), x], 1)
    x = x + p["backbone.pos_embed"]
    for blk, rate in zip(block_names(arch), drop_path_rates(arch)):
        def block(x, blk=blk, rate=rate):
            keep = 1.0 - rate
            y = attention(layer_norm(x, p, f"{blk}.norm1", eps), p,
                          f"{blk}.attn", heads, prec)
            x = x + drop(y, masks.get(f"{blk}.attn"), keep)
            y = mlp(layer_norm(x, p, f"{blk}.norm2", eps), p, f"{blk}.mlp",
                    prec)
            return x + drop(y, masks.get(f"{blk}.mlp"), keep)
        x = checkpoint.checkpoint(block, x, use_reentrant=False) if remat \
            else block(x)
    x = layer_norm(x, p, "backbone.norm", eps)
    return x[:, 0] if arch.get("pool", "cls") == "cls" else x[:, 1:].mean(1)


def backbone_flops(arch: Dict, batch: int) -> int:
    """Operations of one backbone forward of ``batch`` images."""
    cin, p = arch["in_chans"], arch["patch_size"]
    r = arch["mlp_ratio"]
    d = arch["embed_dim"]
    npatch = (arch["image_size"] // p) ** 2
    n = npatch + 1
    per_block = (2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d
                 + 2 * 2 * n * d * int(d * r))
    return batch * (2 * npatch * p * p * cin * d + arch["depth"] * per_block)


def attention_calls(arch: Dict, batch: int, kind: str
                    ) -> List[Tuple[float, float]]:
    e, heads = arch["embed_dim"], arch["num_heads"]
    d = e // heads
    n = (arch["image_size"] // arch["patch_size"]) ** 2 + 1
    return [vit_call(batch, n, e, heads, d, kind) for _ in range(arch["depth"])]


def vit_call(b: int, n: int, e: int, heads: int, d: int, kind: str
             ) -> Tuple[float, float]:
    """K1 (serve), K2 (train_fwd) or K3 (train_bwd) on (b, n, 3e) qkv."""
    qkv, out, bias = b * n * 3 * e, b * n * e, 3 * e
    if kind == "train_bwd":
        return (2 * qkv + out + bias) * 2 + bias * 4, 10.0 * b * heads * n * n * d
    nbytes = (qkv + bias + out) * 2
    if kind == "train_fwd":
        nbytes += b * heads * n * 4
    return nbytes, 4.0 * b * heads * n * n * d
