"""Package-level contracts of the PyTorch port: it never imports JAX, its
configurations carry across from the JAX package, the faithful uint8 chain
runs, and the paths not ported yet refuse clearly."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from optical_flow_tpu import config as j_config
from optical_flow_tpu_torch import config as t_config
from optical_flow_tpu_torch import convert

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "optical_flow_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import optical_flow_tpu_torch, optical_flow_tpu_torch.convert\n"
        "import optical_flow_tpu_torch.kernels, optical_flow_tpu_torch.pipeline\n"
        "import optical_flow_tpu_torch.parallel, optical_flow_tpu_torch.kernels.probes\n"
        "import optical_flow_tpu_torch.utils.profiling, optical_flow_tpu_torch.io\n"
        "import optical_flow_tpu_torch.io.prefetch, optical_flow_tpu_torch.io.video_reader\n"
        "import optical_flow_tpu_torch.pipeline.graphs, optical_flow_tpu_torch.track.pose\n"
        "import optical_flow_tpu_torch.__main__, optical_flow_tpu_torch.flow.horn_schunck\n"
        "from optical_flow_tpu_torch.pipeline.video import VideoPipeline, replay_video\n"
        "import optical_flow_tpu_torch.slam, optical_flow_tpu_torch.slam.frontend\n"
        "import optical_flow_tpu_torch.slam.window, optical_flow_tpu_torch.slam.pnp\n"
        "import optical_flow_tpu_torch.slam.descriptors, optical_flow_tpu_torch.slam.pose_graph\n"
        "import optical_flow_tpu_torch.slam.stereo, optical_flow_tpu_torch.slam.incremental\n"
        "import optical_flow_tpu_torch.utils.interop\n"
        "import optical_flow_tpu_torch.pipeline.serve, optical_flow_tpu_torch.io.preview\n"
        "import optical_flow_tpu_torch.io.video_writer, optical_flow_tpu_torch.utils.metrics\n"
        "import optical_flow_tpu_torch.utils.guard, optical_flow_tpu_torch.utils.images\n"
        "import optical_flow_tpu_torch.utils.viz, optical_flow_tpu_torch.utils.goldens\n"
        "import optical_flow_tpu_torch.utils.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'optical_flow_tpu' or m.startswith('optical_flow_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|optical_flow_tpu)(\s|\.|$)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("make", ["fast", "fast_120", "default"])
def test_video_config_from_jax(make):
    build = {
        "fast": lambda m: m.VideoConfig.fast(),
        "fast_120": lambda m: m.VideoConfig.fast(size=(120, 120)),
        "default": lambda m: m.VideoConfig(),
    }[make]
    assert convert.video_config_from_jax(build(j_config)) == build(t_config)


def test_flow_config_impl_mapping():
    f = convert.flow_config_from_jax(j_config.FlowConfig(impl="jnp", pyr_impl="pallas",
                                                         mode="corrected", level_iters=2))
    assert (f.impl, f.pyr_impl, f.mode, f.level_iters) == ("torch", "auto", "corrected", 2)
    assert convert.flow_config_from_jax(j_config.FlowConfig(impl="pallas")).impl == "cuda"
    with pytest.raises(ValueError):
        convert.flow_config_from_jax(j_config.FlowConfig(pyr_impl="mxu"))
    # the port's own fields are exactly the JAX package's
    names = [x.name for x in dataclasses.fields(t_config.FlowConfig)]
    assert names == [x.name for x in dataclasses.fields(j_config.FlowConfig)]


def test_pipeline_state_from_jax_fresh_and_warm():
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    pipe = VideoPipeline(t_config.VideoConfig.fast(size=(16, 16)), device="cpu")
    pipe.restore(convert.pipeline_state_from_jax(
        {"prev_gray": None, "prev_diff": None, "frame_idx": 0}))
    assert pipe.state() == {"prev_gray": None, "prev_diff": None, "frame_idx": 0}
    g = np.arange(256, dtype=np.float32).reshape(16, 16)
    state = convert.pipeline_state_from_jax({"prev_gray": g, "prev_diff": g * 2, "frame_idx": 5})
    pipe.restore(state)
    got = pipe.state()
    assert got["frame_idx"] == 5 and torch.equal(got["prev_diff"], torch.from_numpy(g * 2))


def test_unported_paths_refuse():
    from optical_flow_tpu_torch.flow.coarse_to_fine import resolve_warp_impl
    from optical_flow_tpu_torch.pipeline.preprocess import preprocess_frame
    from optical_flow_tpu_torch.pipeline.video import VideoPipeline

    # the faithful uint8 chain is ported: the default configuration builds a
    # pipeline, and a uint8 frame gives a uint8 gray of the configured size
    pipe = VideoPipeline(t_config.VideoConfig(), device="cpu")
    assert pipe.config.preprocess.faithful_uint8 and pipe.config.flow.mode == "reference"
    gray = preprocess_frame(torch.full((8, 8, 3), 7, dtype=torch.uint8),
                            t_config.PreprocessConfig(size=(16, 16)))
    assert gray.dtype == torch.uint8 and tuple(gray.shape) == (16, 16)
    assert bool((gray == 7).all())  # a flat frame stays flat through resize, blur and gray
    # the exact shift warp is ported: half the clamp, +1 of fixed-point slack
    assert resolve_warp_impl(t_config.FlowConfig(warp_impl="shift", warp_clamp=8.0), True) == (
        "shift", 5)
    with pytest.raises(ValueError):  # its reach needs a clamp
        resolve_warp_impl(t_config.FlowConfig(warp_impl="shift"), True)
    # 'auto' follows the device: shift_sep only for CUDA frames
    cfg = t_config.FlowConfig(warp_clamp=8.0)
    assert resolve_warp_impl(cfg, False) == ("gather", 0)
    assert resolve_warp_impl(cfg, True) == ("shift_sep", 4)


def test_kernel_build_and_checks_fail_loudly(tmp_path, monkeypatch):
    from optical_flow_tpu_torch.kernels import _lib

    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.build()
    assert not (tmp_path / "kernels").exists()
    assert _lib.library_path() == _lib.library_path()  # named by a content hash
    with pytest.raises(ValueError):
        _lib.check_cuda_f32("test", torch.zeros(2))  # CPU tensors never reach a kernel


def test_exports_cover_the_jax_package():
    import optical_flow_tpu
    import optical_flow_tpu.flow
    import optical_flow_tpu.track

    import optical_flow_tpu_torch
    import optical_flow_tpu_torch.flow
    import optical_flow_tpu_torch.track

    for j, t in ((optical_flow_tpu, optical_flow_tpu_torch),
                 (optical_flow_tpu.flow, optical_flow_tpu_torch.flow),
                 (optical_flow_tpu.track, optical_flow_tpu_torch.track)):
        missing = sorted(set(j.__all__) - set(t.__all__))
        assert not missing, (t.__name__, missing)
        assert all(hasattr(t, name) for name in t.__all__)
    assert optical_flow_tpu_torch.track.track_features is optical_flow_tpu_torch.track.sparse_lk.track_features
    # slam/: the port exports every name of JAX's, the sharded bundle
    # adjustments included, and nothing else
    import optical_flow_tpu.slam
    import optical_flow_tpu_torch.slam

    assert set(optical_flow_tpu_torch.slam.__all__) <= set(optical_flow_tpu.slam.__all__)
    assert all(hasattr(optical_flow_tpu_torch.slam, name) for name in optical_flow_tpu_torch.slam.__all__)
    missing = set(optical_flow_tpu.slam.__all__) - set(optical_flow_tpu_torch.slam.__all__)
    assert missing == set(), sorted(missing)
    # parallel/distributed.py: JAX's four functions, under the same names
    import optical_flow_tpu_torch.parallel.distributed as tdist

    for name in ("initialize_distributed", "global_flow_mesh", "host_local_frames",
                 "make_global_batch"):
        assert callable(getattr(tdist, name)), name
    assert (PKG / "parallel" / "distributed.py").exists() and (PKG / "dryrun.py").exists()
    import optical_flow_tpu_torch.slam.imu as imu

    for name in ("estimate_gyro_bias", "preintegrate_with_bias_jacobians",
                 "visual_inertial_alignment_with_bias"):
        assert callable(getattr(imu, name))
    for module in ("epipolar", "pnp", "ba", "window", "frontend", "descriptors", "pose_graph",
                   "stereo", "incremental", "imu", "vi_ba"):
        assert (PKG / "slam" / f"{module}.py").exists()
    # the serving path and the CLI surfaces: every public name of JAX's
    # module, under the same module path; utils/compat.py (the TPU runtime's
    # persistent compile cache and codec/compile deadlock workaround) has no
    # counterpart
    import importlib

    for module in ("pipeline.serve", "io.preview", "io.video_writer", "utils.metrics",
                   "utils.guard", "utils.images", "utils.viz", "utils.goldens",
                   "utils.checkpoint", "utils.profiling"):
        jm = importlib.import_module(f"optical_flow_tpu.{module}")
        tm = importlib.import_module(f"optical_flow_tpu_torch.{module}")
        names = {n for n, v in vars(jm).items() if not n.startswith("_") and (
            getattr(v, "__module__", None) == jm.__name__ or n.isupper())}
        missing = sorted(n for n in names if not hasattr(tm, n))
        assert not missing, (module, missing)
    from optical_flow_tpu.pipeline import serve as j_serve
    from optical_flow_tpu_torch.pipeline import serve as t_serve

    for name in ("PROTOCOL_VERSION", "MAX_FRAME_BYTES", "MAX_PROC_DIM"):
        assert getattr(t_serve, name) == getattr(j_serve, name), name
    assert t_serve._PipelinePool.MAX_FREE_PER_KEY == j_serve._PipelinePool.MAX_FREE_PER_KEY == 4
    assert callable(t_serve._make_config)
    assert not (PKG / "utils" / "compat.py").exists()


def _jax_track_configs():
    from optical_flow_tpu.flow.horn_schunck import HornSchunckConfig
    from optical_flow_tpu.track.pose import RansacConfig
    from optical_flow_tpu.track.sparse_lk import SparseLKConfig

    return {
        "sparse_lk": (convert.sparse_lk_config_from_jax, SparseLKConfig,
                      dict(win=21, max_level=3, iters=10, eps=0.01, min_eig_threshold=1e-3,
                           impl="shift", margin=4)),
        "ransac": (convert.ransac_config_from_jax, RansacConfig,
                   dict(n_hypotheses=64, inlier_px=1.5, seed=7)),
        "horn_schunck": (convert.horn_schunck_config_from_jax, HornSchunckConfig,
                         dict(alpha=0.5, iters=40, levels=None, warp_clamp=None,
                              warp_impl="gather")),
    }


@pytest.mark.parametrize("which", ["sparse_lk", "ransac", "horn_schunck"])
@pytest.mark.parametrize("default", [True, False])
def test_track_and_hs_configs_from_jax(which, default):
    fn, jcls, kw = _jax_track_configs()[which]
    jcfg = jcls() if default else jcls(**kw)
    got = fn(jcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(jcls)]
    if default:
        assert got == type(got)()  # the port's defaults are the JAX package's
