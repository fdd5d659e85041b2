"""JAX variables → the port's state_dict.

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
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# flax module name → the port's submodule name, per parent module
_RENAMES = {
    "mlp": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "metadata_branch": {"fc1": "net.0", "bn1": "net.1", "fc2": "net.4",
                        "bn2": "net.5"},
    "classifier": {"fc1": "0", "fc2": "3"},
    "attn": {"cpb_fc1": "cpb_mlp.0", "cpb_fc2": "cpb_mlp.2"},
    "backbone": {"patch_norm": "patch_embed.norm"},
}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
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


def _name(path: Tuple[str, ...]) -> str:
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
        parts.append(_RENAMES.get(parent, {}).get(p, p))
    leaf = path[-1]
    parts.append(_LEAVES.get(leaf, leaf))
    return ".".join(parts)


def state_dict_from_jax(variables: Dict[str, Any],
                        patch_size: Optional[int] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for JAX ISICClassifier ``variables`` (ViT or
    SwinV2 backbone, MetadataBranch, ClassifierHead). ``patch_size`` defaults
    to 16 for a ViT and 4 for a SwinV2. Raises on a leaf of a module the port
    does not have yet (the old-generation branches)."""
    params = variables["params"]
    swin = "layers_0" in params.get("backbone", {})
    if patch_size is None:
        patch_size = 4 if swin else 16
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        if path[0] not in ("backbone", "metadata_branch", "classifier"):
            raise NotImplementedError(
                f"{'/'.join(path)}: no counterpart in fedvit_torch yet")
        name = _name(path)
        if path[-1] == "kernel":
            if "patch_embed" in path:
                rows, d = v.shape
                c = rows // (patch_size * patch_size)
                v = v.reshape(patch_size, patch_size, c, d).transpose(3, 2, 0, 1)
            elif path[-3:-1] == ("downsample", "reduction"):
                c4, c2 = v.shape
                v = v.reshape(4, c4 // 4, c2)[_MERGE_CHUNKS].reshape(c4, c2).T
            else:
                v = v.T
        if swin and path[1] == "patch_embed":   # a Dense with no proj level
            name = name.replace("patch_embed.", "patch_embed.proj.")
        sd[name] = torch.from_numpy(np.ascontiguousarray(v))
    for path, v in _flatten(variables.get("batch_stats", {})).items():
        sd[_name(path)] = torch.from_numpy(np.asarray(v, np.float32).copy())
        if path[-1] == "mean":
            sd[_name(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return sd
