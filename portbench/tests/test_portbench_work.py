"""The bytes-once and operation counts against hand-computed values."""

import pytest

from portbench import registry, work

TEDDY = registry.find_cell("teddy-ssd-sgm.stream8").config
# KITTI 2015's geometry with a 7x7 pixelwise census, as a census
# configuration would state it.
KITTI = dict(TEDDY, width=1242, estimator=dict(
    TEDDY["estimator"], cost="census", census_window=7, kernel_size=1))


def test_teddy_ssd_sgm():
    img, vol = 375 * 450, 375 * 450 * 128              # 168,750; 21,600,000
    assert work.stage_work("cost", TEDDY) == (2 * img * 4 + vol * 4,
                                              vol * 28)
    assert work.stage_work("cost", TEDDY) == (87_750_000, 604_800_000)
    assert work.stage_work("aggregation", TEDDY) == (173_475_000,
                                                     1_555_200_000)
    assert work.stage_work("reduce", TEDDY) == (87_075_000, 21_600_000)
    # Bytes bind both: 87.75 MB / 3.35 TB/s = 26.19 us.
    assert work.least_seconds(*work.stage_work("cost", TEDDY)) == \
        pytest.approx(87_750_000 / 3.35e12)
    assert work.roofline_pct("aggregation", TEDDY, 1.0) == pytest.approx(
        173_475_000 / 3.35e12 / 1e-3 * 100)


def test_kitti_census_sgm():
    img, vol = 375 * 1242, 375 * 1242 * 128             # 465,750; 59,616,000
    # 48 neighbours a pixel (compare, shift, OR) in two images; two code
    # words a cell (XOR, population count, add).
    assert work.stage_work("cost", KITTI) == (
        2 * img * 4 + vol * 4, 2 * img * 48 * 3 + vol * 2 * 3)
    assert work.stage_work("cost", KITTI) == (242_190_000, 491_832_000)
    assert work.stage_work("aggregation", KITTI) == (478_791_000,
                                                     4_292_352_000)
    assert work.least_seconds(*work.stage_work("aggregation", KITTI)) == \
        pytest.approx(478_791_000 / 3.35e12)


def with_options(config, **options):
    return dict(config, estimator=dict(config["estimator"], **options))


def test_half_volumes_count_two_bytes_a_value():
    img, vol = 375 * 450, 375 * 450 * 128
    half = with_options(TEDDY, cost_dtype="bfloat16")
    assert work.stage_work("cost", half) == (2 * img * 4 + vol * 2,
                                             vol * 28)
    assert work.stage_work("aggregation", half)[0] == 2 * vol * 2 + img * 4


def test_uncounted_stages_give_nothing():
    assert work.stage_work("cost", with_options(TEDDY, cost="ncc")) is None
    assert work.stage_work("aggregation",
                           with_options(TEDDY, aggregation="cvf")) is None
    assert work.roofline_pct("cost", TEDDY, None) is None
