"""Carry configurations and streaming state across from the JAX package.

The functions read the JAX objects by field name and import nothing of JAX,
so they take the dataclasses of ``optical_flow_tpu.config``, of
``optical_flow_tpu.track``, ``optical_flow_tpu.flow.horn_schunck`` and
``optical_flow_tpu.slam.epipolar``, the numpy dict of
``optical_flow_tpu.pipeline.VideoPipeline.state()``, a
``jax.sharding.Mesh`` (through its ``shape``) and a
``optical_flow_tpu.slam.BAProblem`` (its arrays read through numpy) as they
are.
The system has no learned weights; its carried state is that streaming
state, and the operator matrices are rebuilt by the same numpy code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optical_flow_tpu_torch.config import (
    FlowConfig,
    GestureConfig,
    MeshConfig,
    PreprocessConfig,
    VideoConfig,
)
from optical_flow_tpu_torch.flow.horn_schunck import HornSchunckConfig
from optical_flow_tpu_torch.parallel.mesh import AXIS_COLS, AXIS_FRAMES, AXIS_ROWS, FlowMesh, flow_mesh
from optical_flow_tpu_torch.slam.ba import BAProblem
from optical_flow_tpu_torch.slam.epipolar import EssentialRansacConfig
from optical_flow_tpu_torch.track.pose import RansacConfig
from optical_flow_tpu_torch.track.sparse_lk import SparseLKConfig

_IMPL = {"jnp": "torch", "pallas": "cuda", "auto": "auto"}
_PYR_IMPL = {"poly": "poly", "pallas": "auto", "auto": "auto"}


def _fields(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def flow_config_from_jax(cfg) -> FlowConfig:
    """JAX FlowConfig -> port FlowConfig: impl 'jnp' -> 'torch',
    'pallas' -> 'cuda'; pyr_impl 'pallas'/'auto' -> 'auto'. The MXU column
    form (pyr_impl='mxu') has no counterpart and raises."""
    f = _fields(FlowConfig, cfg)
    if f["impl"] not in _IMPL:
        raise ValueError(f"unknown JAX impl {f['impl']!r}")
    if f["pyr_impl"] not in _PYR_IMPL:
        raise ValueError(f"JAX pyr_impl {f['pyr_impl']!r} has no counterpart in the port")
    f["impl"] = _IMPL[f["impl"]]
    f["pyr_impl"] = _PYR_IMPL[f["pyr_impl"]]
    return FlowConfig(**f)


def video_config_from_jax(cfg) -> VideoConfig:
    """JAX VideoConfig -> port VideoConfig (field by field)."""
    pre = _fields(PreprocessConfig, cfg.preprocess)
    pre["size"] = tuple(pre["size"])
    return VideoConfig(
        preprocess=PreprocessConfig(**pre),
        flow=flow_config_from_jax(cfg.flow),
        gesture=GestureConfig(**_fields(GestureConfig, cfg.gesture)),
        faithful_prev_diff=cfg.faithful_prev_diff,
        batch=cfg.batch,
    )


def pipeline_state_from_jax(state: dict) -> dict:
    """The numpy dict of the JAX ``VideoPipeline.state()`` -> what the
    port's ``VideoPipeline.restore`` takes. A data conversion only: the
    tensors stay on the CPU, and ``restore`` moves them to the pipeline's
    device."""

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return {
        "prev_gray": t(state["prev_gray"]),
        "prev_diff": t(state["prev_diff"]),
        "frame_idx": int(state["frame_idx"]),
    }


def mesh_config_from_jax(cfg) -> MeshConfig:
    """JAX MeshConfig -> port MeshConfig (field by field)."""
    return MeshConfig(**_fields(MeshConfig, cfg))


def flow_mesh_from_jax(mesh, devices) -> FlowMesh:
    """A FlowMesh of the JAX mesh's (frames, rows, cols) shape over the
    port's ``devices`` (a JAX device is no torch device; repeats are
    allowed, as in ``flow_mesh``)."""
    shape = dict(mesh.shape)
    return flow_mesh(shape[AXIS_FRAMES], shape[AXIS_ROWS], shape[AXIS_COLS], devices=devices)


def sparse_lk_config_from_jax(cfg) -> SparseLKConfig:
    """JAX SparseLKConfig -> port SparseLKConfig (field by field; impl
    'auto' keeps the port's meaning, 'gather' on every device)."""
    return SparseLKConfig(**_fields(SparseLKConfig, cfg))


def ransac_config_from_jax(cfg) -> RansacConfig:
    """JAX RansacConfig -> port RansacConfig (field by field; the seed
    seeds the port's own sampler, not threefry)."""
    return RansacConfig(**_fields(RansacConfig, cfg))


def horn_schunck_config_from_jax(cfg) -> HornSchunckConfig:
    """JAX HornSchunckConfig -> port HornSchunckConfig (field by field;
    warp_impl 'auto' keeps the port's meaning, resolve_warp_impl's)."""
    return HornSchunckConfig(**_fields(HornSchunckConfig, cfg))


def essential_ransac_config_from_jax(cfg) -> EssentialRansacConfig:
    """JAX EssentialRansacConfig -> port EssentialRansacConfig (field by
    field; the seed seeds the port's own 8-point sampler, and the 5-point
    solver's RandomState as in JAX)."""
    return EssentialRansacConfig(**_fields(EssentialRansacConfig, cfg))


def ba_problem_from_jax(problem) -> BAProblem:
    """A JAX BAProblem -> the port's, each array a CPU tensor of its own
    dtype (``weight`` and ``baseline`` carried when present). A data
    conversion only: ``bundle_adjust`` keeps the tensors on the CPU, or
    ``device=`` moves them."""

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return BAProblem(
        t(problem.cams), t(problem.points), t(problem.cam_idx), t(problem.pt_idx),
        t(problem.obs), float(problem.focal), t(problem.weight), t(problem.baseline),
    )
