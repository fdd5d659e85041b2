"""ISIC-2019 table assembly (host side, pandas) — the port of
``fedvit_tpu/data/isic.py``.

Builds the (train_df, test_df) pair the rest of the port consumes: one row
per usable sample with `image`, `dx`, `label`, `image_path`, `lesion_id` and
the encoded metadata columns (`age_norm`, `sex_idx`, `site_idx`).

  * ground-truth labels via argmax over the one-hot class columns, UNK
    rows discarded (reference data.py:343-350)
  * metadata encoding: age NaN→50, clipped to [0, 90], scaled by 1/90;
    sex/site lowercased through the vocabs with an unknown fallback; the
    site column may be `anatom_site_general` or its `_challenge` variant;
    `lesion_id` defaults to the image id (reference data.py:353-375)
  * samples whose JPEG is absent from the split directory are dropped
  * three test-split shapes: labelled (GT + metadata), unlabelled
    (metadata + images only → placeholder dx="MEL"/label=0), or none
    (reference data.py:378-427)

pandas is imported where files are read, so the rest of the port runs
without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

from fedvit_torch.data.constants import (LABEL_TO_IDX, NUM_CLASSES, SEX_VOCAB,
                                         SITE_VOCAB, VALID_CLASSES)

_ONEHOT_ORDER = ("MEL", "NV", "BCC", "AK", "BKL", "DF", "VASC", "SCC", "UNK")
_SITE_COLUMNS = ("anatom_site_general", "anatom_site_general_challenge")
_PLACEHOLDER_DX = "MEL"

Log = Callable[[str], None]


def _vocab_encode(series: pd.Series, vocab: dict) -> pd.Series:
    """Lowercase → vocab index, with NaN and out-of-vocab → 'unknown'."""
    idx = series.fillna("unknown").astype(str).str.lower().map(vocab)
    return idx.fillna(vocab["unknown"]).astype(int)


def parse_groundtruth_csv(csv_path: Path) -> pd.DataFrame:
    """One-hot GT CSV → frame of [image, dx, label] for the 8 kept classes."""
    import pandas as pd

    raw = pd.read_csv(csv_path)
    onehot_cols = [c for c in _ONEHOT_ORDER if c in raw.columns]
    raw["dx"] = raw[onehot_cols].idxmax(axis=1)
    kept = raw[raw["dx"].isin(VALID_CLASSES)].copy()
    kept["label"] = kept["dx"].map(LABEL_TO_IDX)
    return kept[["image", "dx", "label"]]


def load_metadata(path: Path) -> pd.DataFrame:
    """Metadata CSV → frame with encoded age_norm/sex_idx/site_idx columns
    appended (and lesion_id guaranteed present)."""
    import pandas as pd

    meta = pd.read_csv(path)
    if "lesion_id" not in meta.columns:
        meta["lesion_id"] = meta["image"]
    if "age_approx" in meta.columns:
        meta["age_norm"] = meta["age_approx"].fillna(50).clip(0, 90) / 90.0
    else:
        meta["age_norm"] = 0.5
    if "sex" in meta.columns:
        meta["sex_idx"] = _vocab_encode(meta["sex"], SEX_VOCAB)
    else:
        meta["sex_idx"] = SEX_VOCAB["unknown"]
    site_col = next((c for c in _SITE_COLUMNS if c in meta.columns), None)
    if site_col is not None:
        meta["site_idx"] = _vocab_encode(meta[site_col], SITE_VOCAB)
    else:
        meta["site_idx"] = SITE_VOCAB["unknown"]
    return meta


def _attach_paths(df: pd.DataFrame, image_dir: Path,
                  split: str, log: Log) -> pd.DataFrame:
    """Add `image_path` and keep only rows whose JPEG exists (one directory
    listing, not a stat() per row)."""
    on_disk = ({p.stem for p in image_dir.glob("*.jpg")}
               if image_dir.is_dir() else set())
    present = df["image"].isin(on_disk)
    dropped = int((~present).sum())
    if dropped:
        log(f"[isic] {split}: dropping {dropped:,} rows with no JPEG "
            f"under {image_dir.name}/")
    kept = df[present].reset_index(drop=True)
    kept["image_path"] = [str(image_dir / f"{name}.jpg")
                          for name in kept["image"]]
    return kept


def _labelled_split(gt_csv: Path, meta_csv: Path, image_dir: Path,
                    split: str, log: Log) -> pd.DataFrame:
    labels = parse_groundtruth_csv(gt_csv)
    frame = labels.merge(load_metadata(meta_csv), on="image", how="left")
    frame = _attach_paths(frame, image_dir, split, log)
    log(f"[isic] {split}: {len(frame):,} labelled samples")
    return frame


def _placeholder_split(meta_csv: Path, image_dir: Path, log: Log) -> pd.DataFrame:
    """Images + metadata but no GT: inference-only rows carrying the
    placeholder label that has_real_test_labels() later recognizes."""
    frame = load_metadata(meta_csv)
    frame.insert(1, "dx", _PLACEHOLDER_DX)
    frame.insert(2, "label", 0)
    frame = _attach_paths(frame, image_dir, "test", log)
    log(f"[isic] test: {len(frame):,} unlabelled images (placeholder labels; "
        f"metrics will be skipped)")
    return frame


def load_isic_data(isic_dir: str,
                   log: Optional[Log] = None) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Assemble (train_df, test_df) from an ISIC-2019 directory layout."""
    import pandas as pd

    log = log or print
    root = Path(isic_dir)
    train_df = _labelled_split(
        root / "ISIC_2019_Training_GroundTruth.csv",
        root / "ISIC_2019_Training_Metadata.csv",
        root / "ISIC_2019_Training_Input", "train", log)

    test_gt = root / "ISIC_2019_Test_GroundTruth.csv"
    test_meta = root / "ISIC_2019_Test_Metadata.csv"
    test_img = root / "ISIC_2019_Test_Input"
    if test_gt.exists() and test_meta.exists():
        test_df = _labelled_split(test_gt, test_meta, test_img, "test", log)
    elif test_meta.exists() and test_img.exists():
        test_df = _placeholder_split(test_meta, test_img, log)
    else:
        log("[isic] no test split on disk; evaluation limited to CV folds")
        test_df = pd.DataFrame(columns=train_df.columns)
    return train_df, test_df


def has_real_test_labels(test_df: pd.DataFrame) -> bool:
    """False for an empty frame or one that looks placeholder-labelled
    (every row dx="MEL"/label identical — the shape _placeholder_split
    emits; reference gates metrics the same way at train.py:361)."""
    if len(test_df) == 0:
        return False
    if test_df["label"].nunique() > 1:
        return True
    return test_df["dx"].iloc[0] != _PLACEHOLDER_DX


def print_class_distribution(df: pd.DataFrame, name: str,
                             log: Optional[Log] = None) -> None:
    """Per-class sample counts and shares for a labelled frame."""
    log = log or print
    counts = df["label"].value_counts()
    denom = max(len(df), 1)
    log(f"[isic] {name} class distribution, {len(df):,} samples:")
    for idx, cls in enumerate(VALID_CLASSES[:NUM_CLASSES]):
        n = int(counts.get(idx, 0))
        log(f"[isic]   {cls:<5} {n:7,}  {100.0 * n / denom:6.2f}%")
