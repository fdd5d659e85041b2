"""JAX variables → the port's state_dict; torch/timm weights files → a
fresh model's state_dict.

``state_dict_from_jax`` is the inverse of
``fedvit_tpu/models/import_weights.py::import_torch_isic``: it takes the JAX
``ISICClassifier``'s ``{"params", "batch_stats"}`` tree (nested dicts of
numpy arrays, e.g. from ``jax.device_get``) and returns a ``state_dict`` for
``fedvit_torch.models.isic.ISICClassifier`` with the reference/timm names.
Dense kernels (in, out) become Linear weights (out, in); the patch embedding's
Dense kernel, rows in (py, px, c) order, becomes timm's conv weight
(D, C, P, P); flax's LayerNorm/BatchNorm ``scale`` becomes ``weight``.

A SwinV2 backbone (``layers_{s}`` in the tree) is the exact inverse of
``import_torch_swin``: ``patch_norm`` becomes ``patch_embed.norm``,
``cpb_fc1``/``cpb_fc2`` become ``cpb_mlp.0``/``cpb_mlp.2``, and the patch
merging at the end of stage s becomes ``layers.{s+1}.downsample`` with the four
pixel chunks of its reduction kernel permuted from row-major to timm's order.

The old generation's modules keep JAX's names (``seg_branch``, ``fusion``, the
head's ``ln``, ``metadata_branch`` in either style) with torch's leaf names.
Conv kernels (kh, kw, in, out) become (out, in, kh, kw); the decoder's
transposed convs (``up{i}``) become (in, out, kh, kw) flipped in both spatial
axes, since flax's ``nn.ConvTranspose`` correlates; embedding tables keep
their layout; the U-Net's ``batch_stats`` become ``running_mean`` and
``running_var``. ``load_jax_variables`` loads such a tree into a model.

The file-level import (``load_torch_file``, ``import_pretrained_file``) is
the port of the other half of ``fedvit_tpu/models/import_weights.py``: a
timm or reference weights file (``.pt``/``.pth``/``.bin``, ``.safetensors``,
``.npz``) onto a fresh model's ``state_dict``. The port's names already are
timm's, so the conversion is the ``backbone.`` prefix, the reference's
4-channel patch-embed surgery and the ViT position-embedding resample.
``.safetensors`` is read by ``read_safetensors``, which needs no
``safetensors`` package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from fedvit_torch.core.config import Config
from fedvit_torch.ops.image import resize

# flax module name → the port's submodule name, per parent module
_RENAMES = {
    "mlp": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "metadata_branch": {"fc1": "net.0", "bn1": "net.1", "fc2": "net.4",
                        "bn2": "net.5"},
    "classifier": {"fc1": "0", "fc2": "3"},
    "classifier_ln": {"fc1": "0", "ln": "2", "fc2": "4"},
    "attn": {"cpb_fc1": "cpb_mlp.0", "cpb_fc2": "cpb_mlp.2"},
    "backbone": {"patch_norm": "patch_embed.norm"},
}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var",
           "embedding": "weight"}
_MODULES = ("backbone", "metadata_branch", "classifier", "seg_branch",
            "fusion")
_TRANSPOSED = re.compile(r"^up\d+$")
_BLOCK = re.compile(r"^blocks_(\d+)$")
_STAGE = re.compile(r"^layers_(\d+)$")
_MERGE_CHUNKS = [0, 2, 1, 3]   # row-major ↔ timm's 2×2 pixel-chunk order


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (str(k),)))
    return out


def _name(path: Tuple[str, ...], head_ln: bool = False) -> str:
    parts = []
    for i, p in enumerate(path[:-1]):
        m = _BLOCK.match(p)
        if m:
            parts.append(f"blocks.{m.group(1)}")
            continue
        m = _STAGE.match(p)
        if m:   # the merge at the end of stage s opens timm's stage s + 1
            s = int(m.group(1)) + (path[i + 1] == "downsample")
            parts.append(f"layers.{s}")
            continue
        parent = path[i - 1] if i else ""
        if parent == "classifier" and head_ln:
            parent = "classifier_ln"
        parts.append(_RENAMES.get(parent, {}).get(p, p))
    leaf = path[-1]
    parts.append(_LEAVES.get(leaf, leaf))
    return ".".join(parts)


def state_dict_from_jax(variables: Dict[str, Any],
                        patch_size: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for JAX ISICClassifier ``variables`` (ViT or
    SwinV2 backbone, either metadata branch, the classifier head with or
    without its LayerNorm, the segmentation branch and the fusion).
    ``patch_size`` defaults to 16 for a ViT and 4 for a SwinV2. Raises on a
    leaf of a module the port does not have. A partial tree (gradients of
    some leaves) gives the entries of those leaves."""
    params = variables["params"]
    swin = "layers_0" in params.get("backbone", {})
    head_ln = "ln" in params.get("classifier", {})
    if patch_size is None:
        patch_size = 4 if swin else 16
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        if path[0] not in _MODULES:
            raise NotImplementedError(
                f"{'/'.join(path)}: no counterpart in fedvit_torch")
        name = _name(path, head_ln)
        if path[-1] == "kernel":
            if "patch_embed" in path:
                rows, d = v.shape
                c = rows // (patch_size * patch_size)
                v = v.reshape(patch_size, patch_size, c, d).transpose(3, 2, 0, 1)
            elif path[-3:-1] == ("downsample", "reduction"):
                c4, c2 = v.shape
                v = v.reshape(4, c4 // 4, c2)[_MERGE_CHUNKS].reshape(c4, c2).T
            elif v.ndim == 4 and _TRANSPOSED.match(path[-2]):
                v = v[::-1, ::-1].transpose(2, 3, 0, 1)
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            else:
                v = v.T
        if swin and path[1] == "patch_embed":   # a Dense with no proj level
            name = name.replace("patch_embed.", "patch_embed.proj.")
        sd[name] = torch.from_numpy(np.ascontiguousarray(v))
    for path, v in _flatten(variables.get("batch_stats", {})).items():
        sd[_name(path)] = torch.from_numpy(np.asarray(v, np.float32).copy())
        # torch's BatchNorm (the MLP metadata branch) counts its batches;
        # the U-Net's flax-semantics BatchNorm keeps no count
        if path[-1] == "mean" and path[0] != "seg_branch":
            sd[_name(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Dict[str, Any],
                       patch_size: Optional[int] = None) -> torch.nn.Module:
    """Load JAX ISICClassifier ``variables`` into the port's ``model``,
    strictly, but for one case: a model with ``metadata.style: embedding``
    loads a tree without ``metadata_branch`` and keeps its own init there.
    JAX creates those parameters on no entry point (every caller passes the
    flat ``metadata`` and never ``metadata_raw``, so the branch never runs
    at init); the port has them, and with no ``metadata_raw`` they change no
    output. Returns ``model``."""
    sd = state_dict_from_jax(variables, patch_size)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if getattr(model, "metadata_style", "mlp") != "mlp" and \
            "metadata_branch" not in variables["params"]:
        missing = [k for k in missing if not k.startswith("metadata_branch.")]
    if missing or unexpected:
        raise KeyError(f"the JAX variables do not fit the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    return model


# ---------------------------------------------------------------------------
# File-level import — a torch/timm weights file onto a fresh model's
# state_dict: the deployable form of the reference's `pretrained: true`
# (config.yaml:31; timm's download, then `_modify_input_channels`,
# model.py:112-124,150-166), with the download done on another machine.
# ---------------------------------------------------------------------------

# the dtypes of timm's and the reference's weights files
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header of each tensor's dtype, shape and byte
    range, then the tensors' raw little-endian bytes. Each tensor is read
    into a buffer of its own, so the file is held in memory once."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        base = 8 + n
        size = os.fstat(f.fileno()).st_size
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                                 f"which this reader does not take")
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * torch.empty(
                    (), dtype=dtype).element_size() or base + end > size:
                raise ValueError(f"{path}: {name}'s byte range {begin}-{end} "
                                 f"does not hold a {info['dtype']} tensor of "
                                 f"shape {list(shape)}")
            f.seek(base + begin)
            flat = (torch.frombuffer(bytearray(f.read(end - begin)),
                                     dtype=dtype)
                    if count else torch.empty(0, dtype=dtype))
            out[name] = flat.reshape(shape)
    return out


def _unwrap_state_dict(obj) -> Dict[str, Any]:
    """Unwrap the containers real checkpoints ship in: {"state_dict": ...},
    {"model": ...} (timm's hub format), DDP "module." prefixes."""
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in obj.items()}


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pt``/``.pth``/``.bin`` (``torch.load(weights_only=True)``),
    ``.safetensors`` or ``.npz`` weights file as a flat {name: CPU tensor}
    state dict."""
    p = str(path)
    if p.endswith(".safetensors"):
        return read_safetensors(p)
    if p.endswith(".npz"):
        with np.load(p) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    obj = torch.load(p, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v) for k, v in _unwrap_state_dict(obj).items()}


def expand_source_patch_embed(sd: Dict[str, torch.Tensor], new_in: int = 4
                              ) -> Dict[str, torch.Tensor]:
    """The reference's `_modify_input_channels` surgery (model.py:150-166)
    on the source conv kernel (D, C, P, P): the RGB kernels kept, each extra
    channel the mean of the RGB kernels (in fp32)."""
    key = "patch_embed.proj.weight"
    if key not in sd:
        return sd
    w = sd[key]
    if w.ndim != 4 or w.shape[1] >= new_in:
        return sd
    w = w.float()
    mean = w.mean(dim=1, keepdim=True)
    out = dict(sd)
    out[key] = torch.cat([w, mean.expand(-1, new_in - w.shape[1], -1, -1)],
                         dim=1)
    return out


def resample_vit_pos_embed(pos: torch.Tensor, n_tokens_new: int
                           ) -> torch.Tensor:
    """Bicubic-resample a ViT absolute position embedding (1, 1+N, D) to a
    new grid (1, 1+M, D), the cls token kept — timm's
    `resample_abs_pos_embed` semantics, with ``jax.image.resize``'s bicubic
    (antialiased when it shrinks the grid: ``ops/image.py::resize``)."""
    cls_tok, grid = pos[:, :1], pos[:, 1:]
    g_old = int(round(float(np.sqrt(grid.shape[1]))))
    g_new = int(round(float(np.sqrt(n_tokens_new))))
    if g_old * g_old != grid.shape[1]:
        raise ValueError(f"non-square source pos-embed grid of "
                         f"{grid.shape[1]} tokens")
    if g_new * g_new != n_tokens_new:
        raise ValueError(f"non-square target pos-embed grid of "
                         f"{n_tokens_new} tokens")
    if g_old == g_new:
        return pos
    d = grid.shape[-1]
    resized = resize(grid.float().reshape(1, g_old, g_old, d), (g_new, g_new))
    return torch.cat([cls_tok.float(), resized.reshape(1, g_new * g_new, d)],
                     dim=1)


def _derive_depths(keys) -> Union[int, Tuple[int, ...]]:
    """The backbone's architecture from its state-dict keys: a ViT's block
    count (int), a SwinV2's per-stage block counts (tuple)."""
    keys = list(keys)
    if any(k.startswith("layers.") for k in keys):
        stages: Dict[int, int] = {}
        for k in keys:
            m = re.match(r"layers\.(\d+)\.blocks\.(\d+)\.", k)
            if m:
                s, b = int(m.group(1)), int(m.group(2))
                stages[s] = max(stages.get(s, 0), b + 1)
        return tuple(stages[s] for s in sorted(stages))
    depth = 0
    for k in keys:
        m = re.match(r"blocks\.(\d+)\.", k)
        if m:
            depth = max(depth, int(m.group(1)) + 1)
    return depth


def import_pretrained_file(sd: Dict[str, torch.Tensor], cfg: Config,
                           target: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """A loaded weights file onto ``target``, a fresh ISICClassifier's
    ``state_dict`` for ``cfg``; returns the new state dict (each tensor in
    its target's dtype and device). Two kinds of file:

      * a bare timm backbone (`patch_embed.*`, `blocks.*` / `layers.*`):
        the backbone imported, the head and the metadata branch keep their
        fresh init (what the reference gets from timm.create_model with a
        fresh classifier, model.py:112-145);
      * a full reference ISICClassifier (`backbone.*`, `classifier.*`,
        `metadata_branch.*`): every tensor imported (the metadata branch
        when the file has one; BatchNorm's `num_batches_tracked` when it
        has them).

    The patch embed gets the 4-channel surgery when ``cfg`` feeds masks and
    the file is RGB; a ViT's or an EVA-02's position embedding is resampled
    when the grid differs. Every imported tensor must be in the file with the
    target's shape, and the file's blocks must be the model's; keys the model
    does not have (a timm head, SwinV2's index buffers) are left out, but for
    an EVA-02 (timm's names: ``attn.q_proj``, ``attn.k_proj`` without a bias,
    ``attn.v_proj``, ``mlp.fc1_g``, ``mlp.fc1_x``, ``mlp.norm``, ``mlp.fc2``,
    ``fc_norm``), where any backbone key but timm's ``head`` raises: a fused
    ``qkv``, a ``k_proj.bias`` or a final ``norm`` is another block."""
    full = any(k.startswith("backbone.") for k in sd)
    bb = ({k[len("backbone."):]: v for k, v in sd.items()
           if k.startswith("backbone.")} if full else dict(sd))
    bb = expand_source_patch_embed(bb, cfg.in_channels)
    if "pos_embed" in bb and "backbone.pos_embed" in target:
        bb["pos_embed"] = resample_vit_pos_embed(
            bb["pos_embed"], target["backbone.pos_embed"].shape[1] - 1)
    want = _derive_depths(k[len("backbone."):] for k in target
                          if k.startswith("backbone."))
    got = _derive_depths(bb)
    if got != want:
        raise ValueError(f"the weights file's backbone has blocks {got}, the "
                         f"model's {cfg.model.backbone} has {want}")
    source = {"backbone." + k: v for k, v in bb.items()}
    if cfg.model.backbone.startswith("eva02_"):
        unknown = sorted(k for k in source if k not in target
                         and not k.startswith("backbone.head."))
        if unknown:
            raise KeyError(f"the weights file has {unknown[:5]}, which the "
                           f"model's {cfg.model.backbone} does not have")
    parts = ["backbone."]
    if full:
        source.update({k: v for k, v in sd.items()
                       if not k.startswith("backbone.")})
        parts.append("classifier.")
        if any(k.startswith("metadata_branch.") for k in sd):
            parts.append("metadata_branch.")
    out: Dict[str, torch.Tensor] = {}
    for key, fresh in target.items():
        if not key.startswith(tuple(parts)) or (
                key.endswith("num_batches_tracked") and key not in source):
            out[key] = fresh
            continue
        if key not in source:
            raise KeyError(f"{key} is not in the weights file")
        value = torch.as_tensor(source[key])
        if tuple(value.shape) != tuple(fresh.shape):
            raise ValueError(f"{key}: the file's shape {tuple(value.shape)}, "
                             f"the model's {tuple(fresh.shape)}")
        out[key] = value.to(device=fresh.device, dtype=fresh.dtype)
    return out
