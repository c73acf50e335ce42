"""The port's command line (``python -m optical_flow_tpu_torch``): ``flow``,
``video`` and ``serve`` against the JAX package's CLI on the same inputs,
with ``--device cpu``.

- ``flow``: the ``_u.txt``/``_v.txt`` files (the reference's saveMat
  format) and the ``.flo`` file against JAX's ``flow`` output on the same
  PNG pair at the slice bar (median |dflow| < 1e-3 px, q99 < 0.02 px over
  the interior; tests/test_torch_slice.py), pyramidal and single level.
- ``video``: on raw BGR frames (``pipe:WxH:PATH``), each ``frame i:`` line
  against JAX's: votes within 1%, the detected flags equal; the metrics
  line on stderr and the annotated PNGs. The frames are the slice tests'
  (a textured patch moving (+3, +2) px a frame).
- ``--fast`` is ``VideoConfig.fast(size=(s, s))`` with only ``impl``
  replaced (pinned here; the JAX CLI's runs ``pyr_impl='poly'``).
- ``serve`` as a subprocess answering one stream, over TCP and a Unix
  socket; ``video --preview 0`` serving its ``/frame.jpg`` during the run.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from optical_flow_tpu import config as j_config
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch.__main__ import main as t_main
from optical_flow_tpu_torch.utils import interop as ti
from optical_flow_tpu_torch.utils.goldens import load_mat
from test_torch_slice import _assert_flow_close, _frames, _texture_pair

REPO = Path(__file__).resolve().parents[1]
VIDEO_HW = (72, 128)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread keeps them from spinning against
    the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png_pair(tmp_path):
    from PIL import Image

    a, b = _texture_pair()
    paths = []
    for name, img in (("a.png", a), ("b.png", b)):
        p = tmp_path / name
        Image.fromarray(np.clip(img * 255.0, 0, 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("single_level", [False, True])
def test_flow_cli_matches_jax(tmp_path, capsys, single_level):
    from optical_flow_tpu.__main__ import _cmd_flow as j_cmd_flow

    img1, img2 = _png_pair(tmp_path)
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    j_cmd_flow(argparse.Namespace(image1=img1, image2=img2, impl="auto", levels=None,
                                  single_level=single_level, out_prefix=jp, flo=jp + ".flo"))
    j_out = capsys.readouterr().out
    extra = ["--single-level"] if single_level else []
    assert t_main(["flow", img1, img2, "--out-prefix", tp, "--flo", tp + ".flo",
                   "--device", "cpu", *extra]) == 0
    t_out = capsys.readouterr().out
    # the same lines, but for the prefix and the mean/max of the flow
    strip = lambda s: re.sub(r"[\d.]+ px", "N px", s.replace(jp, "P").replace(tp, "P"))
    assert strip(j_out) == strip(t_out)
    ju, jv = load_mat(jp + "_u.txt"), load_mat(jp + "_v.txt")
    tu, tv = load_mat(tp + "_u.txt"), load_mat(tp + "_v.txt")
    assert tu.shape == ju.shape == (120, 120)
    _assert_flow_close(ju, jv, tu, tv)
    fu, fv = ti.load_flo(tp + ".flo")
    # the .flo holds the float32 flow, the text its %f (6 decimals) rounding
    np.testing.assert_allclose(fu, tu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fv, tv, rtol=0, atol=1e-6)
    gu, gv = ti.load_flo(jp + ".flo")
    _assert_flow_close(gu, gv, fu, fv)
    # the colour image is flow_to_color of that float32 flow
    from PIL import Image

    from optical_flow_tpu_torch.utils.viz import flow_to_color

    np.testing.assert_array_equal(np.asarray(Image.open(tp + "_flow.png")), flow_to_color(fu, fv))


def _write_raw(tmp_path, frames):
    path = tmp_path / "frames.raw"
    np.stack(frames).tofile(path)
    H, W = frames[0].shape[:2]
    return f"pipe:{W}x{H}:{path}"


_LINE = re.compile(r"frame (\d+): votes=(\d+) detected=(True|False) centroid=\(([-\d.]+),([-\d.]+)\)")


def _frame_lines(out):
    return [(int(m[1]), int(m[2]), m[3] == "True", float(m[4]), float(m[5]))
            for m in _LINE.finditer(out)]


@pytest.mark.parametrize("fast,size", [(True, 96), (False, 48)], ids=["fast-96", "default-48"])
def test_video_cli_matches_jax(tmp_path, capsys, fast, size):
    from optical_flow_tpu.__main__ import _run_video as j_run_video

    n = 8
    spec = _write_raw(tmp_path, list(_frames(n, seed=3, hw=VIDEO_HW)))
    j_run_video(argparse.Namespace(input=spec, frames=n, size=size, impl="auto", metrics=True,
                                   fast=fast, annotate=str(tmp_path / "jax_png"), fps=30.0,
                                   preview=None, gray_decode=False))
    j = capsys.readouterr()
    args = ["video", "--input", spec, "--frames", str(n), "--size", str(size), "--metrics",
            "--annotate", str(tmp_path / "port_png"), "--device", "cpu"]
    assert t_main(args + (["--fast"] if fast else [])) == 0
    t = capsys.readouterr()
    jl, tl = _frame_lines(j.out), _frame_lines(t.out)
    assert len(tl) == len(jl) == n - 2
    for (ji, jv, jd, _, _), (ti_, tv, td, _, _) in zip(jl, tl):
        assert ji == ti_ and jd == td
        assert abs(jv - tv) <= max(1, 0.01 * max(jv, tv)), (jv, tv)
    assert "GUARD TRIPPED" not in t.out
    metrics = json.loads(t.err.strip().splitlines()[-1])
    assert metrics["counters"]["frames"] == n - 2 and "guard_trips" not in metrics["counters"]
    assert metrics["histograms"]["frame"]["count"] == n - 2
    pngs = sorted(os.listdir(tmp_path / "port_png"))
    assert pngs == sorted(os.listdir(tmp_path / "jax_png")) and len(pngs) == n - 2
    assert f"wrote {n - 2} annotated frames" in t.out


def test_video_fast_is_the_preset(monkeypatch):
    """``video --fast`` runs ``VideoConfig.fast(size=(s, s))`` with only impl
    replaced; the JAX CLI rebuilds the flow configuration and so runs
    ``pyr_impl='poly'`` (JAX ``__main__.py:64-73``), the port the preset's
    ``'auto'`` (K2 on the card, equal to 'poly' bit for bit). Without
    ``--fast`` it is the reference-parity ``VideoConfig()`` at the size."""
    from optical_flow_tpu_torch.pipeline import video

    built = []

    class Stop(Exception):
        pass

    def record(cfg, device):
        built.append((cfg, device))
        raise Stop

    monkeypatch.setattr(video, "VideoPipeline", record)
    fast = t_config.VideoConfig.fast(size=(96, 96))
    cases = [(["--fast"], fast),
             (["--fast", "--impl", "pallas"], dataclasses.replace(
                 fast, flow=dataclasses.replace(fast.flow, impl="cuda"))),
             (["--fast", "--impl", "jnp"], dataclasses.replace(
                 fast, flow=dataclasses.replace(fast.flow, impl="torch"))),
             ([], t_config.VideoConfig(preprocess=t_config.PreprocessConfig(size=(96, 96)))),
             (["--impl", "cuda"], t_config.VideoConfig(
                 preprocess=t_config.PreprocessConfig(size=(96, 96)),
                 flow=t_config.FlowConfig(impl="cuda")))]
    for extra, want in cases:
        with pytest.raises(Stop):
            t_main(["video", "--input", "pipe:8x8:none", "--size", "96", "--device", "cpu", *extra])
        assert built[-1] == (want, "cpu"), extra
    assert built[0][0].flow.pyr_impl == "auto"
    # what the JAX CLI builds differs from its own preset in pyr_impl alone
    jf = j_config.VideoConfig.fast(size=(96, 96))
    assert jf.flow.pyr_impl == "auto"
    assert dataclasses.replace(jf.flow, pyr_impl="poly") == j_config.FlowConfig(
        impl="auto", mode="corrected", warp_clamp=8.0, warp_impl="auto")


@pytest.mark.parametrize("transport", ["tcp", "unix"])
def test_serve_cli_answers_a_stream(tmp_path, transport):
    from optical_flow_tpu_torch.pipeline.serve import FlowClient

    where = ["--port", "0"] if transport == "tcp" else ["--unix", str(tmp_path / "s.sock")]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "optical_flow_tpu_torch", "serve", *where,
                             "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"serving flow/gesture streams on (.+)$", line.strip())
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        addr = m[1]
        if transport == "tcp":
            host, port = re.match(r"\('([\d.]+)', (\d+)\)", addr).groups()
            address = (host, int(port))
        else:
            address = addr
        frames = list(_frames(4, seed=5, hw=(60, 80)))
        with FlowClient(address, timeout=60) as c:
            assert c.start_stream(60, 80, proc_size=(48, 64))["ok"]
            replies = [c.push(f) for f in frames]
            assert c.end_stream() == {"end": True, "frames": 4}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert [r.get("warmup", False) for r in replies] == [True, True, False, False]
    assert all({"detected", "cx", "cy", "votes"} <= set(r) for r in replies[2:])


def test_video_preview_end_to_end(tmp_path, capsys, monkeypatch):
    """``video --preview 0``: the stream URL is announced and the
    ``/frame.jpg`` endpoint serves the annotated frame while the loop runs
    (tests/test_preview.py's CLI test, on raw frames)."""
    from optical_flow_tpu_torch.io import preview as prevmod

    spec = _write_raw(tmp_path, list(_frames(5, seed=3, hw=VIDEO_HW)))
    fetched = {}
    orig_push = prevmod.MjpegPreview.push

    def push_and_fetch(self, frame):
        orig_push(self, frame)
        if "data" not in fetched:
            url = f"http://127.0.0.1:{self.address[1]}/frame.jpg"
            fetched["data"] = urllib.request.urlopen(url, timeout=10).read()

    monkeypatch.setattr(prevmod.MjpegPreview, "push", push_and_fetch)
    assert t_main(["video", "--input", spec, "--frames", "5", "--size", "48", "--fast",
                   "--preview", "0", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert re.search(r"live preview at http://\S+:\d+/", err), err
    assert fetched["data"][:2] == b"\xff\xd8"


def test_gray_decode_and_annotate_are_exclusive(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        t_main(["video", "--input", "pipe:8x8:none", "--gray-decode", "--annotate",
                str(tmp_path / "x"), "--device", "cpu"])
    assert not (tmp_path / "x").exists()
