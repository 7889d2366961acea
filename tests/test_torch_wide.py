"""chip_smoke.py's phase 15 (frames wider than one K5 scanning block
spans) rehearsed on the CPU at 36000x64 and 34560x64, where every kernel
is its plain version: "auto" resolves "sat" at 36,000 columns and "fused"
at 34,560, the SAT path's chained frames with every unwarp against its
plain version and the exact unwarp, the SAT batch pair against the
row-blocked plain scan, the single-gaze sampler and the plain 4-tap
sampler (three gazes here: the plain batch pairs hold the CPU's memory),
the direct batch pair against it, the reduced frame against the direct
sampler's, and the fused sampler against its plain version."""

import pytest
import torch

import chip_smoke
from foveax_torch.kernels import scan2d

torch.set_num_threads(1)


def test_wide_paths_on_cpu(capsys):
    errs = {}
    report = chip_smoke.wide_paths(None, errs, heights=(64, 64), device="cpu",
                                   block_rows=16, batches=(3,))
    ran = "ran, peak None tensor bytes, rows equal to the SAT batch's"
    assert report == {"sat": {}, "batch": {3: {}}, "direct_batch": ran,
                      "fused": {"sat": {}, "fused": {}}}
    assert errs == {"unwarp_xy": 0, "sat_build": 0, "sat_sample": 0,
                    "segreduce_xy": 0}
    out = capsys.readouterr().out
    assert "wide 36000x64 -> 20000x48: auto -> sat, 4 chained frames" in out
    assert "batch_pair('auto') launches by gaze count {3: {}}" in out
    assert f"batch_pair('direct') with 3 gazes: {ran}" in out
    assert "wide 34560x64: auto -> fused (223744 bytes of shared memory" in out


def test_unwarp_plain_check_catches_a_flipped_byte():
    """The phase's unwarp check, a channel at a time: an output equal to
    ``unwarp_xy_plain`` passes within 1 LSB of the exact unwarp, and one
    byte changed in the last channel fails it."""
    from foveax_torch.kernels import unwarp as uw

    reduced = chip_smoke.wide_frame(96, 48, "cpu", 4)
    c = torch.tensor([0.3, 0.6])
    out = uw.unwarp_xy(reduced, *uw.fused_vectors(48, 96, 160, 90, c))
    errs = {}
    assert chip_smoke.unwarp_plain_check(errs, reduced, out, c, "test") <= 1
    assert errs == {"unwarp_xy": 0}
    out[2, 45, 80] ^= 1
    with pytest.raises(AssertionError, match="test, channel 2"):
        chip_smoke.unwarp_plain_check(errs, reduced, out, c, "test")


def test_wide_sat_check_carries_and_catches():
    """The row-blocked check carries each block's sums on from the block
    above, and reports a SAT one off in a lower block."""
    frame = chip_smoke.wide_frame(40, 50, "cpu", 3)
    sat = scan2d.sat_scan_plain(frame)
    assert chip_smoke.wide_sat_check(frame, sat, 16) == 0
    bad = sat.view(torch.int32).clone()
    bad[1, 37, 20] += 1
    with pytest.raises(AssertionError, match="rows from 32"):
        chip_smoke.wide_sat_check(frame, bad.view(torch.uint32), 16)
