"""The card's bounds that ``chip_smoke.py`` and ``profile_kernels.py``
report (``repro_torch.kernels.roofline``), checked by hand-counted work;
and ``profile_kernels.py`` loads the same module by its path."""

import pytest

from repro_torch import profile_kernels
from repro_torch.kernels import roofline as rl


@pytest.mark.parametrize("nbytes,ops,rate,by", [
    (3.35e9, 1.0, rl.F32_OPS_PER_S, "bytes"),          # 1 ms of bytes
    (1.0, 67e9, rl.F32_OPS_PER_S, "operations"),       # 1 ms of f32
    (1.0, 989e9, rl.BF16_OPS_PER_S, "operations")])    # 1 ms of bf16
def test_bound_is_the_larger_time(nbytes, ops, rate, by):
    ms, what = rl.bound(nbytes, ops, rate)
    assert ms == pytest.approx(1.0) and what == by


def test_push_bytes_and_onehot_floor():
    # 10 edges, 4 vertices, 2 bins of 2, width 3: 40 B of sources, 24 of
    # bin pointers, 4 active flags, 2 x 4 x 3 x 4 B of payload and output
    assert rl.push_bytes(10, 4, 3, 2, 2) == 40 + 24 + 4 + 96
    # four TF32 products of 64 rows per edge and column, 2 FLOP each
    assert rl.onehot_floor_ms(1000, 2) == pytest.approx(
        8 * 1000 * 64 * 2 / rl.TF32_OPS_PER_S * 1e3)


@pytest.mark.parametrize("T,window,pairs", [
    (4, 1 << 30, 10), (4, 2, 3 + 2 * 2), (1, 17, 1)])
def test_flash_work_counts_the_kept_pairs(T, window, pairs):
    assert rl.flash_pairs(T, window) == pairs
    nbytes, ops = rl.flash_work(2, T, 4, 2, 8, window, 2)
    assert nbytes == (2 * 2 * T * 4 * 8 + 2 * 2 * T * 2 * 8) * 2
    assert ops == 4 * 8 * 2 * 4 * pairs


def test_profile_kernels_loads_the_same_bounds():
    mod = profile_kernels.load_roofline()
    assert mod.__file__ == rl.__file__
    assert mod.bound(1e9, 1e12) == rl.bound(1e9, 1e12)
