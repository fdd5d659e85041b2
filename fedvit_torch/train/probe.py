"""Auto batch-size probe (``fedvit_tpu/train/probe.py``, reference
utils.py:325-350): grow the batch from ``start`` by ``step`` up to ``limit``,
running one forward of synthetic zeros (B, size, size, C) and (B, 13) at each
size, and back off at the first CUDA out-of-memory error, emptying the
allocator's cache after it. In a process group every rank probes and all
take the least size found, so that every rank trains with one size."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedvit_torch.core.config import Config
from fedvit_torch.parallel.mesh import world_size


@torch.inference_mode()
def _forward(model: nn.Module, bs: int, size: int, channels: int,
             meta_dim: int, dev: torch.device) -> None:
    x = torch.zeros((bs, size, size, channels), device=dev)
    meta = torch.zeros((bs, meta_dim), device=dev)
    model(x, meta)["logits"].sum().item()     # waits for the device


def auto_batch_size(cfg: Config, model: Optional[nn.Module] = None,
                    start: int = 8, step: int = 2, limit: int = 64, log=print,
                    device: str = "cuda") -> int:
    """The largest batch size in start, start + step, … ≤ limit whose
    forward ran, before the first that ran out of device memory (``step``,
    at least 1, when even ``start`` did not). ``model`` defaults to
    ``build_model(cfg, device)``."""
    if model is None:
        from fedvit_torch.models import build_model
        model = build_model(cfg, device=device)
    dev = next(model.parameters()).device
    size = cfg.model.image_size
    meta_dim = cfg.model.metadata.input_dim
    model.eval()
    bs = start
    last_ok = max(step, 1)
    while bs <= limit:
        try:
            _forward(model, bs, size, cfg.in_channels, meta_dim, dev)
        except torch.cuda.OutOfMemoryError:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            break
        log(f"[AutoBS] batch_size {bs} OK")
        last_ok = bs
        bs += step
    if world_size() > 1:
        found = torch.tensor([last_ok], device=dev)
        torch.distributed.all_reduce(found, op=torch.distributed.ReduceOp.MIN)
        last_ok = int(found.item())
    log(f"[AutoBS] Using batch_size = {last_ok}")
    return last_ok
