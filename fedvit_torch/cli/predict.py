"""Inference CLI — batch prediction from fold weights, on the GPU.

    python -m fedvit_torch.cli.predict --config config.yaml \
        --checkpoint runs/best_fold0 [--checkpoint runs/best_fold1 ...] \
        --images ./new_lesions/ --output predictions.csv [--tta] [--no-ema] \
        [--device cuda]

The port of ``fedvit_tpu/cli/predict.py``. ``--checkpoint`` is repeated for a
fold ensemble, whose logits are averaged as in the reference
(train.py:446-455). Each is either

  * a checkpoint directory that ``train/loop.py::train_fold`` writes
    (``best_fold{k}``, ``train/checkpoint.py::save_checkpoint``): served with
    the EMA shadow in the model's parameters, as the JAX CLI serves
    ``state.eval_params()``, or with the trained parameters under
    ``--no-ema`` (and always when the run kept no shadow); or
  * a ``.pt`` file holding the port's ``state_dict``
    (``torch.save(model.state_dict(), path)``, or
    ``models/import_weights.py::state_dict_from_jax`` of JAX variables). It
    holds one parameter set, so ``--no-ema`` with a ``.pt`` is refused.

``--device`` picks the device, ``cuda`` by default; without a card the
command fails unless ``--device cpu`` is given.

``--images DIR`` reads a directory of JPEG/PNG images (no labels; the
metadata branch gets the neutral unknown age/sex/site). ``--isic_dir DIR``
reads an ISIC-2019 layout (``data/isic.py``) and predicts its test split,
labelled or unlabelled (reference data.py:378-427), writing the rows in the
test frame's order; with real labels it also prints the classification
report. ``--tta`` averages the logits over the 8 deterministic views before
the ensemble.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _images_dataframe(images_dir: str):
    """A minimal dataframe over a directory of images."""
    import pandas as pd

    exts = {".jpg", ".jpeg", ".png"}
    paths = sorted(p for p in Path(images_dir).iterdir()
                   if p.suffix.lower() in exts)
    if not paths:
        raise SystemExit(f"no images found in {images_dir}")
    return pd.DataFrame({"image": [p.stem for p in paths],
                         "image_path": [str(p) for p in paths],
                         "label": 0})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="ISIC 2019 — batch inference (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument("--checkpoint", action="append", required=True,
                        metavar="PATH", help="checkpoint directory written by "
                        "train_fold, or a .pt file holding the port's "
                        "state_dict (repeat for a fold ensemble)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", type=str, help="Directory of images")
    src.add_argument("--isic_dir", type=str, help="ISIC-2019 data directory "
                     "(predicts the test split)")
    parser.add_argument("--output", type=str, default="predictions.csv")
    parser.add_argument("--logits_out", type=str, default=None,
                        help="Also save the ensembled logits as .npy")
    parser.add_argument("--tta", action="store_true",
                        help="8-view test-time augmentation")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--no-ema", dest="ema", action="store_false",
                        help="Serve a checkpoint directory's trained "
                        "parameters instead of its EMA shadow")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from fedvit_torch.core.config import load_config
    from fedvit_torch.core.device import resolve_device
    from fedvit_torch.data.constants import IDX_TO_LABEL, VALID_CLASSES
    from fedvit_torch.data.isic import has_real_test_labels, load_isic_data
    from fedvit_torch.data.pipeline import HostDataSource, make_device_augment
    from fedvit_torch.eval.metrics import classification_report
    from fedvit_torch.eval.serve import (_evaluate, _softmax,
                                         evaluate_with_tta, make_eval_step)
    from fedvit_torch.models import build_model
    from fedvit_torch.train import checkpoint as ckpt

    for path in args.checkpoint:
        if ckpt.checkpoint_exists(path):
            continue
        if not Path(path).is_file():
            raise SystemExit(f"no checkpoint at {path}")
        if not args.ema:
            raise SystemExit(f"--no-ema needs checkpoint directories: {path} "
                             f"is a .pt state dict, which holds one parameter "
                             f"set")
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.isic_dir is not None:
        _, df = load_isic_data(args.isic_dir, log=lambda s: print(
            s, file=sys.stderr))
        if len(df) == 0:
            raise SystemExit(f"no test split under {args.isic_dir}")
    else:
        df = _images_dataframe(args.images)
    source = HostDataSource(df, cfg)
    bs = args.batch_size or cfg.training.batch_size
    print(f"[predict] {len(source):,} images, {len(args.checkpoint)} "
          f"checkpoint(s), tta={args.tta}, device={device}", file=sys.stderr)

    model = build_model(cfg, device=device)
    eval_step = make_eval_step(model, cfg,
                               augment=make_device_augment(cfg, train=False))
    fold_logits = []
    for path in args.checkpoint:
        if ckpt.checkpoint_exists(path):
            shadow = ckpt.load_serving_weights(path, model, ema=args.ema)
            print(f"[predict] {path}: "
                  f"{'EMA shadow' if shadow else 'trained parameters'}",
                  file=sys.stderr)
        else:
            model.load_state_dict(torch.load(path, map_location=device,
                                             weights_only=True))
        if args.tta:
            _, _, logits = evaluate_with_tta(cfg, model, source, batch_size=bs)
        else:
            logits = _evaluate(eval_step, source, bs, cfg.num_classes)["logits"]
        fold_logits.append(logits)
        print(f"[predict] {path}: done", file=sys.stderr)

    ensembled = np.mean(np.stack(fold_logits), axis=0)
    probs = _softmax(ensembled)
    preds = ensembled.argmax(-1)

    import pandas as pd
    out = pd.DataFrame({"image": df["image"].to_numpy(),
                        "prediction": [IDX_TO_LABEL[int(p)] for p in preds]})
    for i, name in enumerate(VALID_CLASSES):
        out[f"prob_{name}"] = probs[:, i]
    out.to_csv(args.output, index=False)
    print(f"[predict] wrote {args.output}", file=sys.stderr)
    if args.logits_out:
        np.save(args.logits_out, ensembled)
        print(f"[predict] wrote {args.logits_out}", file=sys.stderr)

    if args.isic_dir is not None and has_real_test_labels(df):
        print(classification_report(df["label"].to_numpy(), preds,
                                    VALID_CLASSES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
