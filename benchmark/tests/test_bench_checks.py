"""The training numbers' leaf gaps: the largest and the median of the same
per-leaf gaps, each over the larger of the leaf's reference norm and the
median leaf's."""

import math

import pytest

from benchmark.harness import checks

WANT = {"a": 1.0, "b": 2.0, "c": 4.0, "d": 0.01}


@pytest.mark.parametrize("got, largest, median", [
    (dict(WANT), (0.0, ""), 0.0),
    ({"a": 1.1, "b": 2.0, "c": 4.0, "d": 0.01}, (0.1 / 1.5, "a"), 0.0),
    ({"a": 1.2, "b": 2.2, "c": 4.4, "d": 0.03}, (0.2 / 1.5, "a"), 0.1),
])
def test_largest_and_median_gap(got, largest, median):
    # the median reference norm is 1.5: "a" and "d" are held to it
    value, leaf = checks.leaf_gap(got, WANT)
    assert value == pytest.approx(largest[0]) and leaf == largest[1]
    value, at = checks.median_leaf_gap(got, WANT)
    assert value == pytest.approx(median) and at == "median leaf"


def test_a_missing_leaf_is_not_finite():
    got = {n: v for n, v in WANT.items() if n != "b"}
    assert math.isinf(checks.leaf_gap(got, WANT)[0])
    assert math.isinf(checks.median_leaf_gap(got, WANT)[0])
