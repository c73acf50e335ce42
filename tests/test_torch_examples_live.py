"""The port's live example scripts (optical_flow_tpu_torch/examples/:
live_gesture, serve_stream), each run in process through its
``main(argv)`` with ``--device cpu`` on test_torch_examples_video.py's
clip, and held to the JAX package's script on the same input, run in
process:

  live_gesture      a file and a pipe: source; the JAX script's line count,
                    frame numbers, GESTURE flags and format exactly, its
                    votes within 1% (or 1) and centroids within 0.15 px,
                    with both packages' fast preset voting at 0.5 px
  serve_stream      each package's script against its own FlowServer on
                    the CPU: the handshake's keys, one reply a frame with
                    the JAX replies' keys and flags, votes and centroids at
                    live_gesture's rule, the end of the stream
"""

import json
import re

import numpy as np
import pytest

from test_torch_examples_scenes import _run, _run_jax_script
from test_torch_examples_video import one_thread, video  # noqa: F401 (fixtures)

# The fast preset's 20 px gesture threshold keeps only near-singular
# outlier pixels at these sizes, which roundoff flips (as in
# test_torch_slice._configs); at 0.5 px both packages' VideoConfig.fast
# vote on the moving texture itself (about 2000 votes a frame), a stable
# comparison. Votes are then held at the slice's rule (within 1%, or 1),
# centroids within 0.15 px (the printed one decimal, plus the shift of a
# 1% vote change).
VOTE_THRESH = 0.5
CENTROID_TOL = 0.15
LIVE = re.compile(r"frame (\s*\d+) (GESTURE|       ) votes=(\s*\d+) "
                  r"centroid=\((\s*-?\d+\.\d),(\s*-?\d+\.\d)\)")


@pytest.fixture
def voting_fast(monkeypatch):
    """Both packages' VideoConfig.fast with the gesture threshold at
    VOTE_THRESH (every other knob the preset's)."""
    import dataclasses

    from optical_flow_tpu import config as j_config
    from optical_flow_tpu_torch import config as t_config

    for m in (j_config, t_config):
        preset = m.VideoConfig.fast

        def fast(cls, size=(1080, 1080), _preset=preset, _m=m):
            return dataclasses.replace(_preset(size=size),
                                       gesture=_m.GestureConfig(mag_thresh=VOTE_THRESH))

        monkeypatch.setattr(m.VideoConfig, "fast", classmethod(fast))


def _votes_close(a, b):
    return abs(a - b) <= max(1, 0.01 * max(a, b))


@pytest.mark.parametrize("source", ["file", "pipe"])
def test_live_gesture_equals_the_direct_push(video, source, tmp_path, capsys, monkeypatch,
                                             voting_fast):
    """The port's script and the JAX package's on the same file or pipe:
    source print the same lines (their pushes agree at the slice's rule)."""
    from optical_flow_tpu_torch.io.video_reader import read_frames

    spec = video
    if source == "pipe":
        raw = tmp_path / "frames.raw"
        np.stack(list(read_frames(video, max_frames=6))).tofile(raw)
        spec = f"pipe:160x120@10:{raw}"
    args = ["--input", spec, "--frames", "6", "--size", "48"]
    rc, got = _run("live_gesture", args + ["--device", "cpu"], capsys)
    want = _run_jax_script("live_gesture", args, capsys, monkeypatch)
    assert rc == 0 and len(got) == len(want) == 5, (got, want)
    assert re.fullmatch(r"4 frames in \d+\.\d\ds \(\d+\.\d fps wall incl\. capture\)", got[-1])
    assert got[-1].split(" in ")[0] == want[-1].split(" in ")[0]
    for line, jline in zip(got[:-1], want[:-1]):
        m, jm = LIVE.fullmatch(line), LIVE.fullmatch(jline)
        assert m and jm, (line, jline)
        assert m.group(1, 2) == jm.group(1, 2), (line, jline)  # frame number, flag
        assert _votes_close(int(m.group(3)), int(jm.group(3))), (line, jline)
        assert all(abs(float(m.group(k)) - float(jm.group(k))) <= CENTROID_TOL
                   for k in (4, 5)), (line, jline)
    assert [x[:18] for x in got[:-1]] == [f"frame {n:4d} GESTURE" for n in range(1, 5)]


def _serve_stream(server, run, args):
    server.start_background()
    try:
        host, port = server.address
        return run(args + ["--host", host, "--port", str(port)])
    finally:
        server.shutdown()


def test_serve_stream_against_a_port_server(video, capsys, monkeypatch, voting_fast):
    """Each package's script against its own package's FlowServer on the
    CPU: the handshake, one reply a frame, the end of the stream."""
    from optical_flow_tpu.pipeline.serve import FlowServer as JFlowServer
    from optical_flow_tpu_torch.pipeline.serve import FlowServer

    args = ["--input", video, "--frames", "5", "--size", "48"]
    rc, got = _serve_stream(FlowServer(port=0, device="cpu"),
                            lambda a: _run("serve_stream", a, capsys), args)
    want = _serve_stream(JFlowServer(port=0),
                         lambda a: _run_jax_script("serve_stream", a, capsys, monkeypatch), args)
    assert rc == 0
    replies, jreplies = [json.loads(x) for x in got], [json.loads(x) for x in want]
    assert len(replies) == len(jreplies) == 7
    hello, jhello = replies[0], jreplies[0]
    assert hello["ok"] and sorted(hello) == sorted(jhello)
    assert replies[-1] == jreplies[-1] == {"end": True, "frames": 5}
    served = [r for r in replies[1:-1] if r.get("votes") is not None]
    assert len(served) == 3
    for r, j in zip(replies[1:-1], jreplies[1:-1]):
        assert sorted(r) == sorted(j) and (r.get("votes") is None) == (j.get("votes") is None)
        if r.get("votes") is None:
            assert r == j
            continue
        assert r["detected"] is j["detected"] is True
        assert _votes_close(r["votes"], j["votes"]), (r, j)
        assert abs(r["cx"] - j["cx"]) <= CENTROID_TOL and abs(r["cy"] - j["cy"]) <= CENTROID_TOL
        for k in set(r) - {"votes", "detected", "cx", "cy"}:
            if not isinstance(r[k], float):  # the frame's index, its shape
                assert r[k] == j[k], (k, r, j)
