"""The rooflines' least bytes at both shapes."""

import pytest

from benchmark.trace import load_module

SHAPES = {
    "ref1080p": dict(source_width=1920, source_height=1080, reduced_width=1072, reduced_height=608),
    "equirect8k": dict(source_width=7680, source_height=4320, reduced_width=4272, reduced_height=2400),
}


@pytest.mark.parametrize("shape, viewers, nbytes", [
    ("ref1080p", 1, 6_220_800 + 9 * 1680 + 1_955_328),
    ("equirect8k", 8, 99_532_800 + 8 * 9 * 6672 + 8 * 30_758_400),
])
def test_segreduce_xy_bytes(shape, viewers, nbytes):
    b, ops = load_module("roofline", "segreduce_xy").cost(dict(SHAPES[shape], viewers=viewers))
    assert b == nbytes
    # bytes bound it: the bound is bytes over 3.35 TB/s
    assert ops / 6.7e13 < b / 3.35e12 / 2


@pytest.mark.parametrize("shape, nbytes", [
    ("ref1080p", 1_955_328 + 16 * 3000 + 6_220_800),
    ("equirect8k", 30_758_400 + 16 * 12_000 + 99_532_800),
])
def test_unwarp_xy_bytes(shape, nbytes):
    b, ops = load_module("roofline", "unwarp_xy").cost(dict(SHAPES[shape], viewers=1))
    assert b == nbytes
    assert ops / 6.7e13 < b / 3.35e12 / 2


def test_bound_of_the_8k_broadcast():
    b, _ = load_module("roofline", "segreduce_xy").cost(dict(SHAPES["equirect8k"], viewers=8))
    assert b / 3.35e12 * 1e3 == pytest.approx(0.1033, abs=1e-4)
