"""Checkpoints — the whole train state, for a true resume
(``fedvit_tpu/train/checkpoint.py``), and pretrained starting points.

A checkpoint is a directory:

- ``state.pt`` (``torch.save``): the model's ``state_dict`` (parameters and
  BatchNorm statistics), ``opt_state``, the EMA shadow, ``step``, the
  ``torch.Generator`` state and the numpy ``bit_generator.state``;
- ``meta.json``: the JAX package's keys ``epoch``, ``best_metric``,
  ``epochs_without_improve`` and ``config``.

Restoring both generators makes a resumed run draw what the uninterrupted
one would have drawn from them. In a process group every save is rank 0's
alone, followed by a barrier, and every rank loads. Files are read with ``weights_only=True``.
Checkpoints written by ``fedvit_tpu`` (orbax) are not read here.

A pretrained starting point (``save_pretrained``) is a ``variables.pt``
state dict and ``pretrained_meta.json`` (its backbone, image size and input
channels); ``load_pretrained`` refuses one converted for another model.

The federated server's state (``save_federated_checkpoint``) is a directory
``fed_ckpt`` under the run's workdir holding ``fed_state.pt`` (the global
model's ``state_dict``, the EMA shadow and the seed the clients' generators
derive from) and ``fed_meta.json`` (round, history, the numpy ``PCG64``
state, the config). It is written whole into ``fed_ckpt.tmp`` and swapped
in by two renames, so every crash leaves one loadable generation.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch import nn

from fedvit_torch.core.config import Config, to_dict
from fedvit_torch.parallel.mesh import barrier, is_writer


def _state_tree(state) -> Dict[str, Any]:
    return {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "opt_state": state.opt_state,
        "ema": state.ema,
        "generator": state.generator.get_state(),
        "np_rng": state.np_rng.bit_generator.state,
    }


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, epoch: int, best_metric: float,
                    epochs_without_improve: int = 0,
                    cfg: Optional[Config] = None) -> None:
    """Write a full training checkpoint of ``state`` to ``path`` (a
    directory); in a process group, rank 0 writes and every rank waits for
    it."""
    if is_writer():
        path = Path(path).absolute()
        path.mkdir(parents=True, exist_ok=True)
        _atomic_save(_state_tree(state), path / "state.pt")
        meta = {
            "epoch": int(epoch),
            "best_metric": float(best_metric),
            "epochs_without_improve": int(epochs_without_improve),
            "config": to_dict(cfg) if cfg is not None else None,
        }
        (path / "meta.json").write_text(json.dumps(meta, indent=2,
                                                   default=str))
    barrier()


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    if dst.keys() != src.keys():
        raise ValueError(f"checkpoint holds {sorted(set(src) ^ set(dst))[:5]} "
                         f"where the state does not, or the reverse")
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def load_checkpoint(path: str, state) -> Dict[str, Any]:
    """Restore a checkpoint into ``state`` (built for the same config), in
    place: the model's weights and statistics, the optimizer state, the EMA
    shadow, the step and both generators.

    Returns {"state": state, "epoch", "best_metric",
    "epochs_without_improve", "config"}."""
    path = Path(path).absolute()
    device = next(state.model.parameters()).device
    saved = torch.load(path / "state.pt", map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    opt = saved["opt_state"]
    _copy_into(state.opt_state["mu"], opt["mu"])
    _copy_into(state.opt_state["nu"], opt["nu"])
    state.opt_state["count"] = int(opt["count"])
    if (state.ema is None) != (saved["ema"] is None):
        raise ValueError(f"checkpoint at {path} has EMA "
                         f"{saved['ema'] is not None}, the state "
                         f"{state.ema is not None}")
    if state.ema is not None:
        _copy_into(state.ema, saved["ema"])
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"].cpu())
    state.np_rng.bit_generator.state = saved["np_rng"]
    meta = json.loads((path / "meta.json").read_text())
    meta["state"] = state
    return meta


def checkpoint_exists(path: str) -> bool:
    p = Path(path)
    return (p / "meta.json").exists() and (p / "state.pt").exists()


def load_serving_weights(path: str, model: nn.Module, ema: bool = True) -> bool:
    """Load what a checkpoint directory serves into ``model`` (in place,
    strict): its weights and statistics, with the EMA shadow in place of the
    parameters when ``ema`` and the run kept one (``fedvit_tpu``'s
    ``state.eval_params()``), else the trained parameters. Returns whether
    the shadow was loaded."""
    path = Path(path).absolute()
    device = next(model.parameters()).device
    saved = torch.load(path / "state.pt", map_location=device,
                       weights_only=True)
    weights = dict(saved["model"])
    shadow = ema and saved["ema"] is not None
    if shadow:
        weights.update(saved["ema"])
    model.load_state_dict(weights)
    return shadow


# --- pretrained starting points ----------------------------------------------
#
# A pretrained checkpoint is a model's state dict plus its provenance: a
# starting point, with no optimizer, EMA or step state.

def save_pretrained(path: str, model: nn.Module, cfg: Optional[Config] = None,
                    source: str = "") -> None:
    """Write ``model``'s state dict as a pretrained starting point; in a
    process group, rank 0 writes and every rank waits for it."""
    if is_writer():
        path = Path(path).absolute()
        path.mkdir(parents=True, exist_ok=True)
        _atomic_save(model.state_dict(), path / "variables.pt")
        meta = {
            "kind": "pretrained",
            "source": source,
            "backbone": cfg.model.backbone if cfg else None,
            "image_size": cfg.model.image_size if cfg else None,
            "in_channels": cfg.in_channels if cfg else None,
        }
        (path / "pretrained_meta.json").write_text(json.dumps(meta,
                                                              indent=2))
    barrier()


def load_pretrained(path: str, model: nn.Module,
                    cfg: Optional[Config] = None) -> nn.Module:
    """Load a pretrained starting point into ``model`` (in place, strict);
    refuses one converted for another backbone, image size or channel
    count than ``cfg``'s."""
    path = Path(path).absolute()
    meta = json.loads((path / "pretrained_meta.json").read_text())
    if cfg is not None and meta.get("backbone") is not None:
        for got, want, name in (
                (meta["backbone"], cfg.model.backbone, "backbone"),
                (meta["image_size"], cfg.model.image_size, "image_size"),
                (meta["in_channels"], cfg.in_channels, "in_channels")):
            if got != want:
                raise ValueError(
                    f"pretrained checkpoint at {path} was converted for "
                    f"{name}={got!r} but the config wants {want!r}")
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path / "variables.pt", map_location=device,
                                     weights_only=True))
    return model


def pretrained_exists(path: str) -> bool:
    p = Path(path)
    return (p / "pretrained_meta.json").exists() and (p / "variables.pt").exists()


# --- federated server state ---------------------------------------------------

def _fed_dir(path: str) -> Path:
    """The live federated checkpoint directory, falling back to the ``.old``
    generation if a crash landed between the two swap renames."""
    p = Path(path).absolute()
    live, old = p / "fed_ckpt", p / "fed_ckpt.old"
    if (live / "fed_meta.json").exists():
        return live
    return old


def save_federated_checkpoint(path: str, model: nn.Module,
                              ema_params: Optional[Dict[str, torch.Tensor]],
                              rnd: int, history, np_rng_state: Dict,
                              generator_base: int,
                              cfg: Optional[Config] = None) -> None:
    """Persist the federated server's state after round ``rnd`` to ``path``
    (a directory): the global ``model``'s weights and statistics, the EMA
    shadow, the history, the numpy generator's state and the base seed of the
    clients' generators.

    Crash-safe: state and meta are written together into ``fed_ckpt.tmp/``
    and promoted with two directory renames (atomic on one filesystem); the
    previous generation survives as ``fed_ckpt.old`` until the new one is
    live, so state and meta never desynchronise. In a process group, rank 0
    writes and every rank waits for it."""
    if is_writer():
        _write_federated(Path(path).absolute(), model, ema_params, rnd,
                         history, np_rng_state, generator_base, cfg)
    barrier()


def _write_federated(base: Path, model: nn.Module,
                     ema_params: Optional[Dict[str, torch.Tensor]], rnd: int,
                     history, np_rng_state: Dict, generator_base: int,
                     cfg: Optional[Config]) -> None:
    tmp, live, old = (base / "fed_ckpt.tmp", base / "fed_ckpt",
                      base / "fed_ckpt.old")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save({"model": model.state_dict(), "ema_params": ema_params,
                "generator_base": int(generator_base)}, tmp / "fed_state.pt")
    meta = {
        "round": int(rnd),
        "history": history,
        "np_rng_state": np_rng_state,   # PCG64 state dict — plain ints
        "config": to_dict(cfg) if cfg is not None else None,
    }
    (tmp / "fed_meta.json").write_text(json.dumps(meta, indent=2,
                                                  default=str))
    if old.exists():
        shutil.rmtree(old)
    if live.exists():
        live.rename(old)
    tmp.rename(live)
    if old.exists():
        shutil.rmtree(old)


def load_federated_checkpoint(path: str, model: nn.Module,
                              ema_params: Optional[Dict[str, torch.Tensor]]
                              ) -> Dict[str, Any]:
    """Restore the federated server's state into ``model`` and the EMA shadow
    ``ema_params`` (built for the same config), in place.

    Returns {"round", "history", "np_rng_state", "config",
    "generator_base"}."""
    path = _fed_dir(path)
    device = next(model.parameters()).device
    saved = torch.load(path / "fed_state.pt", map_location=device,
                       weights_only=True)
    model.load_state_dict(saved["model"])
    if (ema_params is None) != (saved["ema_params"] is None):
        raise ValueError(f"federated checkpoint at {path} has EMA "
                         f"{saved['ema_params'] is not None}, the run "
                         f"{ema_params is not None}")
    if ema_params is not None:
        _copy_into(ema_params, saved["ema_params"])
    meta = json.loads((path / "fed_meta.json").read_text())
    return {"round": int(meta["round"]), "history": meta["history"],
            "np_rng_state": meta["np_rng_state"],
            "config": meta.get("config"),
            "generator_base": int(saved["generator_base"])}


def federated_checkpoint_exists(path: str) -> bool:
    p = _fed_dir(path)
    return (p / "fed_meta.json").exists() and (p / "fed_state.pt").exists()
