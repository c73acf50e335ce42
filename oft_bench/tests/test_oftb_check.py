"""The check's own parts: which results the reservoir keeps, in a stream
that resets and in one that does not; the numbers of a planted fault
against the reference; a configuration that feeds its state back refused
on a mix that never resets."""

import pytest
import torch

from oft_bench import check, harness
from oft_bench.reference import plain


@pytest.mark.parametrize("reset", [True, False])
def test_keeper_draws_whole_segments_and_their_last_frames(reset):
    seg = 10
    k = check.Keeper(2 ** 31 + 17, 3, 4, seg, reset, (2, 2), "cpu")
    starts = range(0, 200, seg)
    frames = [g for s in starts for g in range(s + 2 if reset or s == 0 else s, s + seg)]
    for g in frames:
        slot = k.slot(g)
        if slot is not None:
            k.put(slot, torch.full((2, 2), float(g)), torch.zeros(2, 2), torch.zeros(2, 2),
                  [0.0, 0.0, 0.0, 0.0])
    kept = k.kept()
    assert 3 <= len(kept) <= 4
    lows = []
    for segment, got in kept:
        js = [j for j, _ in got]
        assert len(js) == 4 and js[-1] == seg - 1
        lo = 2 if reset or segment == 0 else 0
        assert all(lo <= j < seg for j in js)
        lows += [j for j in js if j < 2]
        for j, s in got:
            assert float(k.planes[s, 0, 0, 0]) == segment * seg + j
    if reset:
        assert not lows


def test_a_tile_is_seen_by_the_share_and_not_by_the_percentile():
    g = torch.Generator().manual_seed(3)
    u, v = (torch.randn(96, 96, generator=g) * 30 for _ in range(2))
    cfg = {"mag_thresh": 20.0, "min_votes": 500, "circle_radius": 35, "norm_alpha": 255.0}
    ref = (u, v, plain.detect_gesture(u, v, cfg))
    moved = u.clone()
    moved[8:16, 8:16] += 1.0
    f = plain.detect_gesture(moved, v, cfg)
    row = check.compare_one(moved, v, f.magnitude,
                            [float(f.detected), float(f.cx), float(f.cy), float(f.votes)], ref)
    assert row["flow_q99_px"] == 0.0 and row["flow_off_share"] == 64 / 96 ** 2
    assert row["flow_max_px"] == pytest.approx(1.0, abs=1e-3)
    same = check.compare_one(u, v, ref[2].magnitude, [float(ref[2].detected), float(ref[2].cx),
                                                      float(ref[2].cy), float(ref[2].votes)], ref)
    assert all(x == 0 for x in same.values())
    flipped = check.compare_one(u, v, ref[2].magnitude, [float(not ref[2].detected),
                                                         float(ref[2].cx), float(ref[2].cy),
                                                         float(ref[2].votes)], ref)
    assert check.worst([flipped, same, flipped])["detected_mismatch"] == 2


def test_a_fed_back_state_needs_a_mix_that_resets(small):
    cfg, mix = small("faithful_1080.stream300")
    mix = dict(mix, reset=False)
    with pytest.raises(ValueError, match="has to reset"):
        harness.Setup(cfg, mix, 1, "cpu")
