"""Plain reference of the ISIC classifier, as functions of named tensors.

The backbones follow timm's published architectures and parameter names
(``vit_base_patch16_224``; ``swinv2_large_window12to24_192to384``), with the
patch embedding widened to 4 input channels (RGB and the lesion mask). The
classifier adds the 13-dim metadata MLP (Linear → BatchNorm → GELU → Dropout
→ Linear → BatchNorm → GELU) and the head (Linear → GELU → Dropout →
Linear) on the pooled features concatenated with the metadata embedding.

Everything is fp32 with exact-erf GELU; ``Precision("fp8")`` rounds every
operand of every product (linear maps, patch embedding, attention scores and
values) to float8 e4m3 and the gradient of every product's output to e5m2,
each with a per-tensor scale, as an fp8 model computes: the control that has
to fail the benchmark's comparison. Dropout and
drop-path masks are passed in, already drawn (``draw_masks``), so that a
block can be recomputed for its backward (``torch.utils.checkpoint``)
without drawing again.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint

Params = Dict[str, torch.Tensor]

FP8_MAX = 448.0          # largest finite float8 e4m3fn
FP8_E5M2_MAX = 57344.0   # largest finite float8 e5m2


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with a per-tensor scale that
    maps its largest magnitude to ``top``."""
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradToE5M2(torch.autograd.Function):
    """The identity forward; the backward rounds the incoming gradient to
    float8 e5m2, as an fp8 model's backward products take it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


class Precision:
    """The precision the products run in: ``fp32`` (no rounding) or
    ``fp8``: every operand of a forward product rounded to float8 e4m3 and
    the gradient reaching a product's output rounded to float8 e5m2 before
    the backward's products, each with a per-tensor scale (an fp8 model's
    forward and backward)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        if self.name == "fp32":
            return x
        with torch.no_grad():
            q = _fp8(x.detach(), torch.float8_e4m3fn, FP8_MAX)
        return x + (q - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result, whose gradient the backward rounds."""
        if self.name == "fp32" or not y.requires_grad:
            return y
        return _GradToE5M2.apply(y)


@contextlib.contextmanager
def fp32_products() -> Iterator[None]:
    """Full fp32 products on the card: no TF32 in matmuls or cuDNN inside
    the block, the flags as they were after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           prec: Precision) -> torch.Tensor:
    return prec.out(F.linear(prec(x), prec(w), b))


def layer_norm(x: torch.Tensor, p: Params, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def mlp(x: torch.Tensor, p: Params, name: str, prec: Precision) -> torch.Tensor:
    h = F.gelu(linear(x, p[f"{name}.fc1.weight"], p[f"{name}.fc1.bias"], prec))
    return linear(h, p[f"{name}.fc2.weight"], p[f"{name}.fc2.bias"], prec)


def drop(x: torch.Tensor, keep_mask: Optional[torch.Tensor],
         keep: float) -> torch.Tensor:
    """Stochastic depth or dropout with a drawn mask: x / keep where kept."""
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))


def patch_embed(img: torch.Tensor, p: Params, name: str, patch: int,
                prec: Precision) -> torch.Tensor:
    """(B, H, W, C) images → (B, H/P, W/P, D): each P×P patch flattened in
    (channel, row, column) order, the layout of a conv kernel (D, C, P, P)."""
    b, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2)
    x = x.reshape(b, c, h // patch, patch, w // patch, patch)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, h // patch, w // patch,
                                             c * patch * patch)
    wt = p[f"{name}.proj.weight"]
    return linear(x, wt.reshape(wt.shape[0], -1), p[f"{name}.proj.bias"], prec)


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

def _heads(arch: Dict, stage: int = 0) -> int:
    h = arch["num_heads"]
    return h[stage] if isinstance(h, (list, tuple)) else h


def feature_dim(arch: Dict) -> int:
    if arch["family"] == "vit":
        return arch["embed_dim"]
    return arch["embed_dim"] * 2 ** (len(arch["depths"]) - 1)


def _block_names(arch: Dict) -> List[str]:
    if arch["family"] == "vit":
        return [f"backbone.blocks.{i}" for i in range(arch["depth"])]
    return [f"backbone.layers.{s}.blocks.{b}"
            for s, d in enumerate(arch["depths"]) for b in range(d)]


def param_spec(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the classifier, in a fixed
    order, with timm's names under ``backbone.`` and the metadata MLP's and
    head's under ``metadata_branch.net.{0,1,4,5}`` and ``classifier.{0,3}``."""
    spec: List[Tuple[str, Tuple[int, ...]]] = []
    cin, patch, d0 = arch["in_chans"], arch["patch_size"], arch["embed_dim"]
    r = arch["mlp_ratio"]

    def lin(name, n_in, n_out, bias=True):
        spec.append((f"{name}.weight", (n_out, n_in)))
        if bias:
            spec.append((f"{name}.bias", (n_out,)))

    def norm(name, dim):
        spec.append((f"{name}.weight", (dim,)))
        spec.append((f"{name}.bias", (dim,)))

    spec.append(("backbone.patch_embed.proj.weight", (d0, cin, patch, patch)))
    spec.append(("backbone.patch_embed.proj.bias", (d0,)))
    if arch["family"] == "vit":
        n = (arch["image_size"] // patch) ** 2 + 1
        spec.append(("backbone.cls_token", (1, 1, d0)))
        spec.append(("backbone.pos_embed", (1, n, d0)))
        for blk in _block_names(arch):
            norm(f"{blk}.norm1", d0)
            lin(f"{blk}.attn.qkv", d0, 3 * d0)
            lin(f"{blk}.attn.proj", d0, d0)
            norm(f"{blk}.norm2", d0)
            lin(f"{blk}.mlp.fc1", d0, int(d0 * r))
            lin(f"{blk}.mlp.fc2", int(d0 * r), d0)
    else:
        norm("backbone.patch_embed.norm", d0)
        for s, depth in enumerate(arch["depths"]):
            c = d0 * 2 ** s
            if s > 0:
                lin(f"backbone.layers.{s}.downsample.reduction", 2 * c, c,
                    bias=False)
                norm(f"backbone.layers.{s}.downsample.norm", c)
            for b in range(depth):
                blk = f"backbone.layers.{s}.blocks.{b}"
                heads = _heads(arch, s)
                spec.append((f"{blk}.attn.q_bias", (c,)))
                spec.append((f"{blk}.attn.v_bias", (c,)))
                spec.append((f"{blk}.attn.logit_scale", (heads, 1, 1)))
                lin(f"{blk}.attn.qkv", c, 3 * c, bias=False)
                lin(f"{blk}.attn.cpb_mlp.0", 2, 512)
                lin(f"{blk}.attn.cpb_mlp.2", 512, heads, bias=False)
                lin(f"{blk}.attn.proj", c, c)
                norm(f"{blk}.norm1", c)
                lin(f"{blk}.mlp.fc1", c, int(c * r))
                lin(f"{blk}.mlp.fc2", int(c * r), c)
                norm(f"{blk}.norm2", c)
    norm("backbone.norm", feature_dim(arch))
    meta, head = arch["metadata"], arch["head"]
    lin("metadata_branch.net.0", meta["input_dim"], meta["hidden_dim"])
    norm("metadata_branch.net.1", meta["hidden_dim"])
    lin("metadata_branch.net.4", meta["hidden_dim"], meta["output_dim"])
    norm("metadata_branch.net.5", meta["output_dim"])
    lin("classifier.0", feature_dim(arch) + meta["output_dim"],
        head["hidden_dim"])
    lin("classifier.3", head["hidden_dim"], head["num_classes"])
    return spec


def drop_path_rates(arch: Dict) -> List[float]:
    """Stochastic depth of each block: linear from 0 to the rate over all
    blocks."""
    n = len(_block_names(arch))
    rate = arch["drop_path_rate"]
    return [rate * i / max(1, n - 1) for i in range(n)]


def draw_masks(arch: Dict, batch: int, generator: torch.Generator,
               device) -> Dict[str, Optional[torch.Tensor]]:
    """Every keep-mask of one training forward, drawn from ``generator`` in
    the order the forward consumes them: for each block with a positive
    drop-path rate, the attention branch's (B, 1, …) mask and then the MLP
    branch's; then the metadata MLP's dropout (B, hidden) and the head's
    (B, hidden). A mask is ``uniform < keep``."""
    masks: Dict[str, Optional[torch.Tensor]] = {}
    ones = (1, 1) if arch["family"] == "vit" else (1, 1, 1)
    for blk, rate in zip(_block_names(arch), drop_path_rates(arch)):
        for branch in ("attn", "mlp"):
            if rate == 0.0:
                masks[f"{blk}.{branch}"] = None
                continue
            u = torch.rand((batch,) + ones, generator=generator, device=device)
            masks[f"{blk}.{branch}"] = u < (1.0 - rate)
    for name, sec in (("metadata", arch["metadata"]), ("head", arch["head"])):
        rate = sec["dropout"]
        if rate == 0.0:
            masks[name] = None
            continue
        u = torch.rand((batch, sec["hidden_dim"]), generator=generator,
                       device=device)
        masks[name] = u < (1.0 - rate)
    return masks


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def vit_attention(x: torch.Tensor, p: Params, name: str, heads: int,
                  prec: Precision) -> torch.Tensor:
    b, n, d = x.shape
    qkv = linear(x, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"], prec)
    q, k, v = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    scores = prec.out(prec(q) @ prec(k).transpose(-2, -1)) * (d // heads) ** -0.5
    out = prec.out(prec(torch.softmax(scores, -1)) @ prec(v))
    out = out.transpose(1, 2).reshape(b, n, d)
    return linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], prec)


def vit_features(img: torch.Tensor, p: Params, arch: Dict,
                 masks: Dict[str, Optional[torch.Tensor]], prec: Precision,
                 remat: bool) -> torch.Tensor:
    eps = arch["ln_eps"]
    heads = arch["num_heads"]
    x = patch_embed(img, p, "backbone.patch_embed", arch["patch_size"], prec)
    b = x.shape[0]
    x = x.reshape(b, -1, x.shape[-1])
    x = torch.cat([p["backbone.cls_token"].expand(b, -1, -1), x], 1)
    x = x + p["backbone.pos_embed"]
    for blk, rate in zip(_block_names(arch), drop_path_rates(arch)):
        def block(x, blk=blk, rate=rate):
            keep = 1.0 - rate
            y = vit_attention(layer_norm(x, p, f"{blk}.norm1", eps), p,
                              f"{blk}.attn", heads, prec)
            x = x + drop(y, masks.get(f"{blk}.attn"), keep)
            y = mlp(layer_norm(x, p, f"{blk}.norm2", eps), p, f"{blk}.mlp",
                    prec)
            return x + drop(y, masks.get(f"{blk}.mlp"), keep)
        x = checkpoint.checkpoint(block, x, use_reentrant=False) if remat \
            else block(x)
    x = layer_norm(x, p, "backbone.norm", eps)
    return x[:, 0] if arch.get("pool", "cls") == "cls" else x[:, 1:].mean(1)


# ---------------------------------------------------------------------------
# SwinV2
# ---------------------------------------------------------------------------

def relative_coords_table(window: int, pretrained_window: int) -> torch.Tensor:
    """SwinV2's log-spaced coordinate table (2w−1, 2w−1, 2), the deltas
    normalised by the pretrained window's extent minus one."""
    r = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    table = table / max((pretrained_window or window) - 1, 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return torch.from_numpy(table.astype(np.float32))


def relative_position_index(window: int) -> torch.Tensor:
    """(w², w²) index into the flattened table of query − key offsets."""
    ys, xs = np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return torch.from_numpy(dy * (2 * window - 1) + dx)


def shift_mask(h: int, w: int, window: int, shift: int) -> Optional[torch.Tensor]:
    """(nW, w², w²) additive mask: −100 between tokens of different regions
    of the cyclically shifted map, None without a shift."""
    if shift == 0:
        return None
    region = torch.zeros(h, w)
    cuts = ((0, h - window), (h - window, h - shift), (h - shift, h))
    cuts_w = ((0, w - window), (w - window, w - shift), (w - shift, w))
    label = 0
    for y0, y1 in cuts:
        for x0, x1 in cuts_w:
            region[y0:y1, x0:x1] = label
            label += 1
    win = region.reshape(h // window, window, w // window, window)
    win = win.permute(0, 2, 1, 3).reshape(-1, window * window)
    return torch.where(win[:, :, None] != win[:, None, :], -100.0, 0.0)


def swin_attention(x: torch.Tensor, p: Params, name: str, heads: int,
                   window: int, pretrained_window: int,
                   mask: Optional[torch.Tensor], prec: Precision,
                   chunk: int) -> torch.Tensor:
    """Scaled cosine attention over windows: x (windows, n, C)."""
    rows, n, c = x.shape
    d = c // heads
    bias = torch.cat([p[f"{name}.q_bias"], torch.zeros_like(p[f"{name}.q_bias"]),
                      p[f"{name}.v_bias"]])
    qkv = linear(x, p[f"{name}.qkv.weight"], bias, prec)
    q, k, v = qkv.reshape(rows, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    table = relative_coords_table(window, pretrained_window).to(x.device)
    hid = F.relu(linear(table, p[f"{name}.cpb_mlp.0.weight"],
                        p[f"{name}.cpb_mlp.0.bias"], prec))
    cpb = linear(hid, p[f"{name}.cpb_mlp.2.weight"], None, prec)
    idx = relative_position_index(window).to(x.device).reshape(-1)
    rel = cpb.reshape(-1, heads)[idx].reshape(n, n, heads).permute(2, 0, 1)
    rel = 16.0 * torch.sigmoid(rel)
    scale = torch.exp(torch.clamp(p[f"{name}.logit_scale"], max=math.log(100.0)))
    qn = F.normalize(q, dim=-1)
    kn = F.normalize(k, dim=-1)
    outs = []
    for s in range(0, rows, chunk):          # windows of ``chunk`` at a time
        e = min(rows, s + chunk)
        att = prec.out(prec(qn[s:e]) @ prec(kn[s:e]).transpose(-2, -1)) * scale + rel
        if mask is not None:
            nw = mask.shape[0]
            att = att + mask[torch.arange(s, e, device=x.device) % nw][:, None]
        outs.append(prec.out(prec(torch.softmax(att, -1)) @ prec(v[s:e])))
    out = torch.cat(outs).transpose(1, 2).reshape(rows, n, c)
    return linear(out, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], prec)


def windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, w², C), the windows of each image together."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def unwindows(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def swin_features(img: torch.Tensor, p: Params, arch: Dict,
                  masks: Dict[str, Optional[torch.Tensor]], prec: Precision,
                  remat: bool, chunk: int = 64) -> torch.Tensor:
    eps = arch["ln_eps"]
    x = patch_embed(img, p, "backbone.patch_embed", arch["patch_size"], prec)
    x = layer_norm(x, p, "backbone.patch_embed.norm", eps)
    rates = iter(drop_path_rates(arch))
    for s, depth in enumerate(arch["depths"]):
        if s > 0:                 # 2×2 merge: chunks (0,0), (1,0), (0,1), (1,1)
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
            x = x.reshape(b, h // 2, w // 2, 4 * c)
            name = f"backbone.layers.{s}.downsample"
            x = linear(x, p[f"{name}.reduction.weight"], None, prec)
            x = layer_norm(x, p, f"{name}.norm", eps)
        _, h, w, _ = x.shape
        window = arch["window_size"]
        clamp = window >= min(h, w)
        window = min(h, w) if clamp else window
        heads = _heads(arch, s)
        pw = arch["pretrained_window_sizes"][s]
        for b_i in range(depth):
            blk = f"backbone.layers.{s}.blocks.{b_i}"
            shift = 0 if (clamp or b_i % 2 == 0) else window // 2
            mask = shift_mask(h, w, window, shift)
            mask = None if mask is None else mask.to(x.device)
            rate = next(rates)

            def block(x, blk=blk, shift=shift, mask=mask, rate=rate,
                      window=window, heads=heads, pw=pw, h=h, w=w):
                keep = 1.0 - rate
                y = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
                y = swin_attention(windows(y, window), p, f"{blk}.attn", heads,
                                   window, pw, mask, prec, chunk)
                y = unwindows(y, window, h, w)
                if shift:
                    y = torch.roll(y, (shift, shift), (1, 2))
                x = x + drop(layer_norm(y, p, f"{blk}.norm1", eps),
                             masks.get(f"{blk}.attn"), keep)
                y = layer_norm(mlp(x, p, f"{blk}.mlp", prec), p,
                               f"{blk}.norm2", eps)
                return x + drop(y, masks.get(f"{blk}.mlp"), keep)
            x = checkpoint.checkpoint(block, x, use_reentrant=False) if remat \
                else block(x)
    x = layer_norm(x, p, "backbone.norm", eps)
    return x.reshape(x.shape[0], -1, x.shape[-1]).mean(1)


# ---------------------------------------------------------------------------
# The classifier
# ---------------------------------------------------------------------------

def batch_norm(x: torch.Tensor, p: Params, name: str, train: bool,
               running: Optional[Params]) -> torch.Tensor:
    """BatchNorm over the batch: its mean and biased variance in training,
    the running statistics in evaluation."""
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean = running[f"{name}.running_mean"]
        var = running[f"{name}.running_var"]
    return (x - mean) / torch.sqrt(var + 1e-5) * p[f"{name}.weight"] \
        + p[f"{name}.bias"]


def classifier(img: torch.Tensor, metadata: torch.Tensor, p: Params,
               arch: Dict, masks: Optional[Dict[str, Optional[torch.Tensor]]],
               prec: Precision, train: bool, running: Optional[Params] = None,
               remat: bool = False) -> torch.Tensor:
    """Logits (B, classes) of images (B, S, S, 4) normalised and metadata
    (B, 13). ``masks`` from ``draw_masks`` in training, None in evaluation;
    ``running`` the BatchNorm running statistics, for evaluation."""
    masks = masks or {}
    feats = (vit_features if arch["family"] == "vit" else swin_features)(
        img, p, arch, masks, prec, remat)
    meta, head = arch["metadata"], arch["head"]
    m = linear(metadata, p["metadata_branch.net.0.weight"],
               p["metadata_branch.net.0.bias"], prec)
    m = F.gelu(batch_norm(m, p, "metadata_branch.net.1", train, running))
    m = drop(m, masks.get("metadata"), 1.0 - meta["dropout"])
    m = linear(m, p["metadata_branch.net.4.weight"],
               p["metadata_branch.net.4.bias"], prec)
    m = F.gelu(batch_norm(m, p, "metadata_branch.net.5", train, running))
    h = F.gelu(linear(torch.cat([feats, m], -1), p["classifier.0.weight"],
                      p["classifier.0.bias"], prec))
    h = drop(h, masks.get("head"), 1.0 - head["dropout"])
    return linear(h, p["classifier.3.weight"], p["classifier.3.bias"], prec)

