"""optical_flow_tpu_torch — the PyTorch/CUDA port of optical_flow_tpu.

Dense pyramidal Lucas–Kanade flow and the streaming video gesture pipeline,
on PyTorch tensors with hand-written CUDA kernels for the H100 (sm_90a) on
the hot path. Module paths and public names mirror the JAX package, which
stays the reference the port is tested against. This package never imports
JAX.

Layer map:
  ops/        dense tensor ops with OpenCV-faithful numerics
  kernels/    K1-K5, P1, S1 and the probes S2-S4 as CUDA kernels (csrc/), with
              their plain PyTorch versions
  utils/      timing, tracing and rooflines on the card, the device an entry
              point runs on, metrics, the guard, checkpoints, images, golden
              files, visualisation and the evaluation formats
  flow/       single-level LK, the coarse-to-fine controller and Horn–Schunck
  parallel/   a grid of devices, halo exchange and the mesh-sharded controller,
              on one process or across processes (distributed.py)
  pipeline/   preprocess -> pyramidal flow -> gesture video pipeline, and the
              server that answers frame streams over a socket (serve.py)
  io/         video decode, prefetch to the card, annotated video output and
              the live MJPEG preview
  track/      sparse tracking: Shi–Tomasi corners, pyramidal sparse LK, RANSAC
              homography (reference of.cpp)
  slam/       structure from motion: essential matrix, PnP, bundle
              adjustment (sharded too), the windowed mapper, two- and
              multi-view reconstruction, the mapper, visual-inertial BA
  __main__.py the command line (``python -m optical_flow_tpu_torch
              {flow,video,track,slam,serve}``)
  convert.py  configurations, streaming state and a mesh's shape from the JAX package
  dryrun.py   dryrun_multichip: the pipeline step, sharded VI-BA and the
              sparse tracker on an n-slot mesh
"""

from optical_flow_tpu_torch.config import (
    FlowConfig,
    GestureConfig,
    PreprocessConfig,
    VideoConfig,
)
from optical_flow_tpu_torch.flow.lk import lucas_kanade
from optical_flow_tpu_torch.flow.coarse_to_fine import (
    coarse_to_fine,
    coarse_to_fine_pyramids,
    coarse_to_fine_with_images,
)
from optical_flow_tpu_torch.flow.horn_schunck import HornSchunckConfig, horn_schunck
from optical_flow_tpu_torch.ops.pyramid import (
    gaussian_pyramid,
    max_pyramid_levels,
    pyr_down,
    pyr_up,
)
from optical_flow_tpu_torch import track

__version__ = "0.1.0"

__all__ = [
    "FlowConfig",
    "GestureConfig",
    "PreprocessConfig",
    "VideoConfig",
    "lucas_kanade",
    "coarse_to_fine",
    "coarse_to_fine_pyramids",
    "coarse_to_fine_with_images",
    "horn_schunck",
    "HornSchunckConfig",
    "track",
    "gaussian_pyramid",
    "max_pyramid_levels",
    "pyr_down",
    "pyr_up",
]
