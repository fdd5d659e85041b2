"""EVA-02, in timm's ``eva02_large_patch14_448`` layout (arXiv:2303.11331):
a class token and learned position embeddings; pre-norm blocks without
layer scale of global attention on separate q, k and v projections (q and v
with a bias, k without), q and k of the patch tokens turned by 2-D rotary
embeddings; a SwiGLU MLP with a LayerNorm over its hidden width; the mean of
the patch tokens after the last block, then ``fc_norm``, as the feature.

The rotation is written here from its equations (timm's
``RotaryEmbeddingCat(in_pixels=False)`` with ``apply_rot_embed_cat``): for a
head of width d, pair j (elements 2j, 2j + 1) of the patch at row r and
column c of a g × g grid turns by

    θ = (r or c) · ref / g · T^(−i / (d/4)),   T = 10,000,

the row for j < d/4 (i = j) and the column for j ≥ d/4 (i = j − d/4), with
positions scaled to the pretraining grid ``ref``; y₂ⱼ = x₂ⱼ cos θ − x₂ⱼ₊₁
sin θ, y₂ⱼ₊₁ = x₂ⱼ₊₁ cos θ + x₂ⱼ sin θ. The class token is not turned.

Everything the harness knows of one architecture, found by the
configuration's ``model.family`` (``harness/manifest.py``): the backbone's
parameters, its reference forward, its operation counts and the names of
the program's attention kernels that run it; and, for this family alone,
the rotation's bytes (``rope_calls``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from benchmark.reference.models import (Params, Precision, drop,
                                        drop_path_rates, layer_norm, linear,
                                        linear_spec, norm_spec, patch_embed)

# the tiny size of the harness's CPU tests: the configuration it cuts, the
# program's backbone at that size (timm's EVA-02-Ti widths), the image and
# canvas sides, the sizes
TINY = {"config": "eva02-large-448", "backbone": "eva02_tiny_patch14_224",
        "image_size": 28, "canvas": 48,
        "model": {"embed_dim": 192, "depth": 12, "num_heads": 3,
                  "mlp_hidden": 512}}

# the program's attention kernels, by the regular expressions their device
# names match: K9's log-sum-exp entry and backward in training (K10's
# kernels without a bias on three flat tensors), K9 in serving
ATTENTION_KERNELS = {
    "train": (r"attn_fwd::fwd_kernel<[^>]*, false, true>",
              r"attn_bwd::delta_kernel<",
              r"attn_bwd::(dkdv|dq)(_mma)?_kernel<[^>]*, false, false>"),
    "serve": (r"attn_fwd::fwd_kernel<[^>]*, false, false>",),
}

# a drop-path mask's shape after the batch: one per image over (tokens, D)
DROP_PATH_SHAPE = (1, 1)


def feature_dim(arch: Dict) -> int:
    return arch["embed_dim"]


def block_names(arch: Dict) -> List[str]:
    return [f"backbone.blocks.{i}" for i in range(arch["depth"])]


def _grid(arch: Dict) -> int:
    return arch["image_size"] // arch["patch_size"]


def backbone_spec(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    cin, patch, d0 = arch["in_chans"], arch["patch_size"], arch["embed_dim"]
    hid = arch["mlp_hidden"]
    n = _grid(arch) ** 2 + 1
    spec = [("backbone.patch_embed.proj.weight", (d0, cin, patch, patch)),
            ("backbone.patch_embed.proj.bias", (d0,)),
            ("backbone.cls_token", (1, 1, d0)),
            ("backbone.pos_embed", (1, n, d0))]
    for blk in block_names(arch):
        spec += norm_spec(f"{blk}.norm1", d0)
        spec += linear_spec(f"{blk}.attn.q_proj", d0, d0)
        spec += linear_spec(f"{blk}.attn.k_proj", d0, d0, bias=False)
        spec += linear_spec(f"{blk}.attn.v_proj", d0, d0)
        spec += linear_spec(f"{blk}.attn.proj", d0, d0)
        spec += norm_spec(f"{blk}.norm2", d0)
        spec += linear_spec(f"{blk}.mlp.fc1_g", d0, hid)
        spec += linear_spec(f"{blk}.mlp.fc1_x", d0, hid)
        spec += norm_spec(f"{blk}.mlp.norm", hid)
        spec += linear_spec(f"{blk}.mlp.fc2", hid, d0)
    return spec + norm_spec("backbone.fc_norm", feature_dim(arch))


def rope_angles(arch: Dict, device) -> torch.Tensor:
    """θ of every (patch, pair), (g², d/2), from the equations above in
    fp64."""
    g, ref = _grid(arch), arch.get("rope_ref_grid", 16)
    d = arch["embed_dim"] // arch["num_heads"]
    quarter = d // 4
    temp = arch.get("rope_temperature", 10000.0)
    patch = torch.arange(g * g, device=device)
    row = (patch // g).double() * ref / g
    col = (patch % g).double() * ref / g
    j = torch.arange(d // 2, device=device)
    inv = temp ** (-(j % quarter).double() / quarter)
    pos = torch.where(j < quarter, row[:, None], col[:, None])
    return pos * inv


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           heads: int) -> torch.Tensor:
    """x (B, N, E): the patch tokens' head pairs turned by θ."""
    b, n, e = x.shape
    xp = x[:, 1:].reshape(b, n - 1, heads, e // heads // 2, 2)
    x0, x1 = xp[..., 0], xp[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    y = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1)
    return torch.cat([x[:, :1], y.reshape(b, n - 1, e)], 1)


def attention(x: torch.Tensor, p: Params, name: str, heads: int,
              cos: torch.Tensor, sin: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    b, n, e = x.shape
    q = rotate(linear(x, p[f"{name}.q_proj.weight"], p[f"{name}.q_proj.bias"],
                      prec), cos, sin, heads)
    k = rotate(linear(x, p[f"{name}.k_proj.weight"], None, prec), cos, sin,
               heads)
    v = linear(x, p[f"{name}.v_proj.weight"], p[f"{name}.v_proj.bias"], prec)
    q, k, v = (t.reshape(b, n, heads, e // heads).transpose(1, 2)
               for t in (q, k, v))
    scores = prec.out(prec(q) @ prec(k).transpose(-2, -1)) * (e // heads) ** -0.5
    out = prec.out(prec(torch.softmax(scores, -1)) @ prec(v))
    out = out.transpose(1, 2).reshape(b, n, e)
    return linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], prec)


def swiglu(x: torch.Tensor, p: Params, name: str, eps: float,
           prec: Precision) -> torch.Tensor:
    h = F.silu(linear(x, p[f"{name}.fc1_g.weight"], p[f"{name}.fc1_g.bias"],
                      prec)) \
        * linear(x, p[f"{name}.fc1_x.weight"], p[f"{name}.fc1_x.bias"], prec)
    h = layer_norm(h, p, f"{name}.norm", eps)
    return linear(h, p[f"{name}.fc2.weight"], p[f"{name}.fc2.bias"], prec)


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
    theta = rope_angles(arch, x.device)
    cos, sin = torch.cos(theta).float(), torch.sin(theta).float()
    for blk, rate in zip(block_names(arch), drop_path_rates(arch)):
        def block(x, blk=blk, rate=rate):
            keep = 1.0 - rate
            y = attention(layer_norm(x, p, f"{blk}.norm1", eps), p,
                          f"{blk}.attn", heads, cos, sin, prec)
            x = x + drop(y, masks.get(f"{blk}.attn"), keep)
            y = swiglu(layer_norm(x, p, f"{blk}.norm2", eps), p, f"{blk}.mlp",
                       eps, prec)
            return x + drop(y, masks.get(f"{blk}.mlp"), keep)
        x = checkpoint.checkpoint(block, x, use_reentrant=False) if remat \
            else block(x)
    return layer_norm(x[:, 1:].mean(1), p, "backbone.fc_norm", eps)


def backbone_flops(arch: Dict, batch: int) -> int:
    """Operations of one backbone forward of ``batch`` images: the patch
    embedding, the q, k, v and output projections, the scores and values,
    the SwiGLU's three maps (the rotation, SiLU, product, norms and the mean
    are not counted)."""
    cin, p = arch["in_chans"], arch["patch_size"]
    d, hid = arch["embed_dim"], arch["mlp_hidden"]
    npatch = _grid(arch) ** 2
    n = npatch + 1
    per_block = (2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d
                 + 2 * 2 * n * d * hid + 2 * n * hid * d)
    return batch * (2 * npatch * p * p * cin * d + arch["depth"] * per_block)


def k9_call(b: int, n: int, e: int, heads: int, d: int, kind: str
            ) -> Tuple[float, float]:
    """K9 (serve), its log-sum-exp entry (train_fwd) or its backward
    (train_bwd) on flat (b, n, e) q, k and v, in bf16: each input byte read
    once and each output byte written once (the backward's own bytes, q, k,
    v, dout in and dq, dk, dv out, as K3's count; out and lse are the
    forward's leftovers)."""
    qkv, out = b * n * 3 * e, b * n * e
    if kind == "train_bwd":
        return (2 * qkv + out) * 2, 10.0 * b * heads * n * n * d
    nbytes = (qkv + out) * 2
    if kind == "train_fwd":
        nbytes += b * heads * n * 4
    return nbytes, 4.0 * b * heads * n * n * d


def attention_calls(arch: Dict, batch: int, kind: str
                    ) -> List[Tuple[float, float]]:
    e, heads = arch["embed_dim"], arch["num_heads"]
    n = _grid(arch) ** 2 + 1
    return [k9_call(batch, n, e, heads, e // heads, kind)
            for _ in range(arch["depth"])]


def rope_calls(arch: Dict, batch: int, kind: str
               ) -> List[Tuple[float, float]]:
    """(bytes, operations) of each rotation of q and k, one a block, in a
    forward (``serve``, ``train_fwd``) or a backward (``train_bwd``, the
    rotation of dq and dk by −θ) of ``batch`` images in bf16: q and k of the
    patch tokens read and written once, the table's cosines and sines
    ((g², d/2) fp32 each) read once. Its operations (6 an element pair) are
    not what bounds it."""
    if kind not in ("serve", "train_fwd", "train_bwd"):
        raise ValueError(f"kind must be serve, train_fwd or train_bwd: {kind!r}")
    e, heads = arch["embed_dim"], arch["num_heads"]
    npatch = _grid(arch) ** 2
    table = 2 * npatch * (e // heads // 2) * 4
    nbytes = 2 * 2 * batch * npatch * e * 2 + table
    return [(float(nbytes), 0.0) for _ in range(arch["depth"])]

