"""Pretrained-weight import CLI — a torch/timm weights file → the port's
pretrained starting point (the port of ``fedvit_tpu/cli/import_weights.py``).

    python -m fedvit_torch.cli.import_weights \
        --weights vit_base_patch16_224.pt --config config.yaml \
        --output ./pretrained/vit_base_224 [--device cuda]

The reference sets `pretrained: true` (config.yaml:31): timm downloads the
backbone and `_modify_input_channels` widens its patch embed to 4 channels
(model.py:112-124, 150-166). Here the download happens on any networked
machine, e.g.

    python -c "import timm, torch; m = timm.create_model(
        'vit_base_patch16_224.augreg2_in21k_ft_in1k', pretrained=True,
        num_classes=0); torch.save(m.state_dict(), 'vit_base_patch16_224.pt')"

and this CLI converts the file (``models/import_weights.py``: the 4-channel
surgery when the config feeds masks, the ViT position-embedding resample
when the image size differs) and writes ``train/checkpoint.py::
save_pretrained`` output. Set `model.pretrained_path: <output>` in the YAML:
``cli.train`` starts every fold from it, and ``load_pretrained`` refuses it
for another backbone, image size or channel count.

A bare timm backbone file keeps the fresh head and metadata init (seeded by
the config's seed); a full reference ISICClassifier file (`backbone.*`,
`classifier.*`, `metadata_branch.*`) imports every tensor. File types: torch
`.pt`/`.pth`/`.bin`, `.safetensors`, `.npz`. ``--device`` picks where the
model is built, ``cuda`` by default; without a card the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert torch/timm pretrained weights to a fedvit_torch "
                    "starting checkpoint")
    parser.add_argument("--weights", type=str, required=True,
                        help="torch .pt/.pth/.bin, .safetensors, or .npz "
                             "state-dict file")
    parser.add_argument("--config", type=str, default="config.yaml",
                        help="Training config the checkpoint will be used "
                             "with (fixes backbone/image_size/in_channels)")
    parser.add_argument("--output", type=str, required=True, metavar="DIR",
                        help="Output checkpoint directory (becomes "
                             "model.pretrained_path)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch

    from fedvit_torch.core.config import load_config
    from fedvit_torch.core.device import resolve_device
    from fedvit_torch.models import build_model
    from fedvit_torch.models.import_weights import (import_pretrained_file,
                                                    load_torch_file)
    from fedvit_torch.train.checkpoint import save_pretrained

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    sd = load_torch_file(args.weights)
    kind = ("full ISICClassifier"
            if any(k.startswith("backbone.") for k in sd) else "backbone")
    print(f"[import] {args.weights}: {len(sd)} tensors ({kind} state dict)",
          file=sys.stderr)

    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    model.load_state_dict(import_pretrained_file(sd, cfg, model.state_dict()))
    save_pretrained(args.output, model, cfg, source=str(args.weights))
    print(f"[import] wrote {args.output} — set model.pretrained_path to it "
          f"to train from these weights", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
