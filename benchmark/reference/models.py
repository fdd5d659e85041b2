"""Plain reference of the ISIC classifier, as functions of named tensors.

The backbone is the configuration's family (``benchmark/families/``: timm's
published architecture and parameter names), with the patch embedding
widened to 4 input channels (RGB and the lesion mask). The classifier adds the 13-dim metadata MLP (Linear → BatchNorm → GELU → Dropout
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
from types import ModuleType
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.harness import manifest

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

def family(arch: Dict) -> ModuleType:
    """What the harness knows of the configuration's architecture:
    ``families/<family>.py`` (``harness/manifest.py``)."""
    return manifest.family_module(arch["family"])


def linear_spec(name: str, n_in: int, n_out: int, bias: bool = True
                ) -> List[Tuple[str, Tuple[int, ...]]]:
    spec = [(f"{name}.weight", (n_out, n_in))]
    if bias:
        spec.append((f"{name}.bias", (n_out,)))
    return spec


def norm_spec(name: str, dim: int) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(f"{name}.weight", (dim,)), (f"{name}.bias", (dim,))]


def param_spec(arch: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the classifier, in a fixed
    order: the family's backbone (timm's names under ``backbone.``), then
    the metadata MLP's and head's under ``metadata_branch.net.{0,1,4,5}``
    and ``classifier.{0,3}``."""
    fam = family(arch)
    spec = fam.backbone_spec(arch)
    meta, head = arch["metadata"], arch["head"]
    spec += linear_spec("metadata_branch.net.0", meta["input_dim"],
                        meta["hidden_dim"])
    spec += norm_spec("metadata_branch.net.1", meta["hidden_dim"])
    spec += linear_spec("metadata_branch.net.4", meta["hidden_dim"],
                        meta["output_dim"])
    spec += norm_spec("metadata_branch.net.5", meta["output_dim"])
    spec += linear_spec("classifier.0", fam.feature_dim(arch) + meta["output_dim"],
                        head["hidden_dim"])
    spec += linear_spec("classifier.3", head["hidden_dim"], head["num_classes"])
    return spec


def drop_path_rates(arch: Dict) -> List[float]:
    """Stochastic depth of each block: linear from 0 to the rate over all
    blocks."""
    n = len(family(arch).block_names(arch))
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
    fam = family(arch)
    for blk, rate in zip(fam.block_names(arch), drop_path_rates(arch)):
        for branch in ("attn", "mlp"):
            if rate == 0.0:
                masks[f"{blk}.{branch}"] = None
                continue
            u = torch.rand((batch,) + fam.DROP_PATH_SHAPE, generator=generator,
                           device=device)
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
    feats = family(arch).features(img, p, arch, masks, prec, remat)
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

