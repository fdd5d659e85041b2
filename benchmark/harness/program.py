"""What the benchmark takes from the program under test (``fedvit_torch``):
its configuration schema, its model with the benchmark's weights loaded by
name, and the entry points the modes drive. Nothing here imports the JAX
package."""

from __future__ import annotations

import copy
from typing import Dict

import torch

from benchmark.harness.manifest import Cell


def merged(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def program_raw(cell: Cell) -> Dict:
    """The program's configuration as a raw dict: the configuration's
    ``program`` section with the mix's ``program`` settings over it."""
    return merged(cell.config["program"], cell.traffic.get("program", {}))


def program_config(cell: Cell):
    from fedvit_torch.core.config import from_dict
    return from_dict(program_raw(cell))


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 running: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's parameters, and its
    BatchNorm statistics into the buffers, by name; the names and shapes
    must be the reference's exactly."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(
            "the program's parameters are not the reference's: only the "
            f"program has {sorted(set(params) - set(weights))[:5]}, only the "
            f"reference {sorted(set(weights) - set(params))[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise RuntimeError(f"{name}: program {tuple(p.shape)}, reference "
                               f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
    buffers = dict(model.named_buffers())
    for name, t in running.items():
        buffers[name].copy_(t)
