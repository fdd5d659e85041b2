"""The port's ISIC-2019 tables and cross-validation splits (``data/isic.py``,
``data/splits.py``) against the JAX package's, on the CPU.

Both are host code on the same numpy and pandas, so everything is held
exactly: the split index arrays bit for bit, the frames by
``pandas.testing.assert_frame_equal`` (dtypes included), the logged lines
string for string."""

import numpy as np
import pandas as pd
import pytest

from fedvit_torch.data import isic as tisic
from fedvit_torch.data import splits as tsplits
from fedvit_tpu.data import isic as jisic
from fedvit_tpu.data import splits as jsplits

from tests.torch_parity import write_isic_tree

SEEDS = (0, 1, 7, 42)


def _labels_groups(seed, n=120, n_groups=45):
    rng = np.random.default_rng(1000 + seed)
    labels = rng.choice(8, n, p=[.18, .5, .13, .04, .1, .01, .01, .03])
    groups = np.array([f"L{g}" for g in rng.integers(0, n_groups, n)])
    return labels, groups


def _same_splits(got, want):
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        assert gt.dtype == wt.dtype and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_splits", (2, 5))
def test_stratified_kfold_matches_jax(seed, n_splits):
    labels, _ = _labels_groups(seed)
    for shuffle in (True, False):
        _same_splits(tsplits.stratified_kfold(labels, n_splits, shuffle, seed),
                     jsplits.stratified_kfold(labels, n_splits, shuffle, seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_splits", (2, 5))
def test_stratified_group_kfold_matches_jax(seed, n_splits):
    labels, groups = _labels_groups(seed)
    got = tsplits.stratified_group_kfold(labels, groups, n_splits, seed)
    _same_splits(got, jsplits.stratified_group_kfold(labels, groups, n_splits,
                                                     seed))
    for train, val in got:                   # no lesion straddles two folds
        assert not set(groups[train]) & set(groups[val])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("groups_kind", ("many", "one", "none"))
def test_make_cv_splits_dispatch_matches_jax(seed, groups_kind):
    """Group K-fold with more than one group; plain stratified K-fold with a
    single group or none."""
    labels, groups = _labels_groups(seed)
    groups = {"many": groups, "one": np.full(len(labels), "L0"),
              "none": None}[groups_kind]
    got = tsplits.make_cv_splits(labels, groups, 5, seed)
    _same_splits(got, jsplits.make_cv_splits(labels, groups, 5, seed))
    if groups_kind != "many":
        _same_splits(got, tsplits.stratified_kfold(labels, 5, True, seed))


def _both(root):
    tlog, jlog = [], []
    got = tisic.load_isic_data(str(root), log=tlog.append)
    want = jisic.load_isic_data(str(root), log=jlog.append)
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)
    assert tlog == jlog
    return got, tlog


@pytest.mark.parametrize("test", ("labelled", "unlabelled", None))
@pytest.mark.parametrize("site_column", ("anatom_site_general",
                                         "anatom_site_general_challenge"))
def test_load_isic_data_matches_jax(tmp_path, test, site_column):
    root = write_isic_tree(tmp_path / "ISIC", test=test,
                           site_column=site_column)
    (train_df, test_df), lines = _both(root)
    # 40 rows − 2 UNK − 3 without a JPEG (one of them UNK)
    assert len(train_df) == 36 and (train_df["dx"] != "UNK").all()
    assert "[isic] train: dropping 2 rows with no JPEG under " \
        "ISIC_2019_Training_Input/" in lines
    assert all(p.endswith(".jpg") for p in train_df["image_path"])
    assert train_df["age_norm"].between(0.0, 1.0).all()
    assert set(train_df["site_idx"]) <= set(range(9))
    assert 8 in set(train_df["site_idx"])          # "nowhere" and None
    assert train_df["lesion_id"].nunique() > 1
    assert tisic.has_real_test_labels(test_df) == (test == "labelled")
    if test is None:
        assert len(test_df) == 0 and list(test_df.columns) == list(
            train_df.columns)
    elif test == "labelled":
        assert len(test_df) == 10                 # 12 − UNK − one missing
    else:
        assert len(test_df) == 11 and (test_df["dx"] == "MEL").all()


def test_groundtruth_and_metadata_fallbacks_match_jax(tmp_path):
    """UNK rows dropped by the one-hot argmax; metadata without lesion_id,
    age, sex or site falls back as JAX's does; out-of-vocabulary and
    mixed-case strings land where JAX's do."""
    root = write_isic_tree(tmp_path / "ISIC", test=None)
    csv = root / "ISIC_2019_Training_GroundTruth.csv"
    got = tisic.parse_groundtruth_csv(csv)
    pd.testing.assert_frame_equal(got, jisic.parse_groundtruth_csv(csv))
    assert len(got) == 38 and got["label"].between(0, 7).all()

    meta = tmp_path / "meta.csv"
    for frame in (pd.DataFrame({"image": ["a", "b"]}),
                  pd.DataFrame({"image": ["a", "b", "c"],
                                "age_approx": [200, np.nan, -5],
                                "sex": ["MALE", "Female", "x"],
                                "anatom_site_general_challenge":
                                    ["Head/Neck", "weird", None]})):
        frame.to_csv(meta, index=False)
        got = tisic.load_metadata(meta)
        pd.testing.assert_frame_equal(got, jisic.load_metadata(meta))
    assert list(got["age_norm"]) == [1.0, 50 / 90, 0.0]
    assert list(got["sex_idx"]) == [0, 1, 2]
    assert list(got["site_idx"]) == [5, 8, 8]


def test_has_real_test_labels_matches_jax():
    frames = [pd.DataFrame(columns=["dx", "label"]),
              pd.DataFrame({"dx": ["MEL", "MEL"], "label": [0, 0]}),
              pd.DataFrame({"dx": ["NV", "NV"], "label": [1, 1]}),
              pd.DataFrame({"dx": ["MEL", "NV"], "label": [0, 1]})]
    got = [tisic.has_real_test_labels(f) for f in frames]
    assert got == [jisic.has_real_test_labels(f) for f in frames]
    assert got == [False, False, True, True]


def test_print_class_distribution_lines_match_jax(tmp_path):
    root = write_isic_tree(tmp_path / "ISIC")
    train_df, _ = tisic.load_isic_data(str(root), log=lambda s: None)
    for frame in (train_df, train_df.iloc[:0]):
        got, want = [], []
        tisic.print_class_distribution(frame, "Full Train", log=got.append)
        jisic.print_class_distribution(frame, "Full Train", log=want.append)
        assert got == want and len(got) == 9
