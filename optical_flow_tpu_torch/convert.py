"""Carry configurations and streaming state across from the JAX package.

The functions read the JAX objects by field name and import nothing of JAX,
so they take the dataclasses of ``optical_flow_tpu.config`` and the numpy
dict of ``optical_flow_tpu.pipeline.VideoPipeline.state()`` as they are.
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
    PreprocessConfig,
    VideoConfig,
)

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


def pipeline_state_from_jax(state: dict, device="cpu") -> dict:
    """The numpy dict of the JAX ``VideoPipeline.state()`` -> what the
    port's ``VideoPipeline.restore`` takes (tensors on ``device``)."""

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x)).to(device)

    return {
        "prev_gray": t(state["prev_gray"]),
        "prev_diff": t(state["prev_diff"]),
        "frame_idx": int(state["frame_idx"]),
    }
