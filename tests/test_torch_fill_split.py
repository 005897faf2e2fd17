"""The cluster size of the wide fill design (``align_torch.cluster_split``:
how many CTAs of one thread-block cluster fill one lane of a
``fill_block`` launch) as a pure function of the launch's lanes, its band
and the card's cluster limits, and ``fill_split`` off the card."""

import pytest
import torch

from lesv_tpu_torch.ops import align_torch

# clusters of each size an H100 holds at once, as the card reports them
# for fill_block (cudaOccupancyMaxActiveClusters)
H100 = {2: 66, 4: 30, 8: 15, 16: 7}
# a card that refuses the non-portable size 16
NO16 = {2: 66, 4: 30, 8: 15, 16: 0}


@pytest.mark.parametrize("B,W,limits,want", [
    # the register design's bands, and the NW's full W 2,049 at 64 lanes
    (1, 2048, H100, 1), (64, 2049, H100, 1), (1, 2049, H100, 1),
    # two CTAs would take 1 or 2 slots off a thread's run of 3 or 4
    (1, 3072, H100, 1), (1, 4095, H100, 1),
    # one NW lane: as many CTAs as leave a slot a thread, up to 16
    (1, 4096, H100, 4), (1, 8192, H100, 8), (1, 16385, H100, 16),
    (1, 32768, H100, 16), (1, 65536, H100, 16), (1, 1 << 20, H100, 16),
    # without size 16 the cap is 8
    (1, 32768, NO16, 8), (1, 1 << 20, NO16, 8),
    # lanes of a launch: every cluster resident at once; the map's 64-lane
    # W 4,096 stays at one CTA, its W 8,192 takes two
    (2, 32768, H100, 16), (8, 32768, H100, 8), (8, 4096, H100, 4),
    (16, 32768, H100, 4), (31, 32768, H100, 2), (64, 4096, H100, 1),
    (64, 8192, H100, 2), (67, 8192, H100, 1), (200, 65536, H100, 1),
])
def test_cluster_split(B, W, limits, want):
    assert align_torch.cluster_split(B, W, limits) == want


@pytest.mark.parametrize("limits", [H100, NO16, {2: 1, 4: 0, 8: 0, 16: 0},
                                    {2: 0, 4: 0, 8: 0, 16: 0}])
def test_cluster_split_stays_within_the_limits(limits):
    """Over lanes and bands: a power of two up to 16, 1 up to W 2,048; a
    split leaves every CTA at least 1,024 slots, keeps the launch's
    clusters within what the card holds at once and takes at least 3 slots
    off a thread's run; doubling it would break one of the first three."""
    def run(W, c):
        return -(-W // (c * 1024))

    for B in (1, 2, 3, 7, 8, 9, 16, 31, 64, 65, 132, 1000):
        for W in (64, 2048, 2049, 3000, 4096, 6000, 8192, 16385, 32768,
                  65536, 131072):
            C = align_torch.cluster_split(B, W, limits)
            assert C in (1, 2, 4, 8, 16)
            if W <= 2048:
                assert C == 1
            if C > 1:
                assert W // C >= align_torch.SPLIT_MIN_SLOTS
                assert B <= limits[C]
                assert run(W, 1) - run(W, C) >= align_torch.SPLIT_MIN_GAIN
                n = 2 * C
                assert (W // n < align_torch.SPLIT_MIN_SLOTS
                        or B > limits.get(n, 0))


@pytest.mark.parametrize("W", [64, 4096, 65536])
def test_fill_split_off_the_card_is_one_cta(W):
    """The plain fill has no CTAs: one, whatever the band, on the CPU."""
    assert align_torch.fill_split(1, W, torch.device("cpu")) == 1
    assert align_torch.fill_split(1, W, "cpu") == 1
