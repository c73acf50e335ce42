"""The seeded ring of frames (``oft_bench/frames.py``)."""

import numpy as np

from oft_bench import frames


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = frames.ring(2 ** 31 + 17, n=4)
    b = frames.ring(2 ** 31 + 17, n=4)
    c = frames.ring(-5, n=4)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert a[0].tobytes() != c[0].tobytes()
    assert a[0].shape == (720, 1280, 3) and a[0].dtype == np.uint8


def test_ring_is_64_distinct_frames_of_continuous_motion_across_the_wrap():
    ring = frames.ring(9)
    assert len(ring) == frames.RING == 64
    assert len({f.tobytes() for f in ring}) == 64
    p = frames.path(0.0)
    steps = [(p[(t + 1) % 64][0] - p[t][0], p[(t + 1) % 64][1] - p[t][1]) for t in range(64)]
    moves = [max(abs(dy), abs(dx)) for dy, dx in steps]
    assert min(moves) >= 1 and max(moves) <= 3  # the wrap 63 -> 0 included
    assert len(set(p)) == 64


def test_each_frame_is_the_background_with_the_patch_at_its_offset():
    seed = 4
    ring = frames.ring(seed, n=64)
    rng = frames._rng(seed)
    frames.smooth_texture(rng, 720, 1280, 4.0)
    frames.smooth_texture(rng, 180, 213, 2.0)
    rng.random(3)
    phase = float(rng.random()) * 2 * np.pi
    offs = frames.path(phase)
    y0, x0 = (720 - 180) // 2, (1280 - 213) // 2
    patch = ring[0][y0 + offs[0][0] : y0 + offs[0][0] + 180, x0 + offs[0][1] : x0 + offs[0][1] + 213]
    for t in (1, 31, 63):
        dy, dx = offs[t]
        np.testing.assert_array_equal(
            ring[t][y0 + dy : y0 + dy + 180, x0 + dx : x0 + dx + 213], patch)
