"""Configuration dataclasses (PyTorch port of optical_flow_tpu/config.py).

Same dataclasses, fields and defaults as the JAX package, so a
configuration reads the same in both. The implementation selectors take
the port's values:

- ``FlowConfig.impl``: ``'torch'`` (the plain PyTorch composition),
  ``'cuda'`` (the hand-written kernels; a CPU tensor reaching a kernel
  wrapper runs the wrapper's plain version) or ``'auto'`` (``'cuda'`` for a
  CUDA tensor, ``'torch'`` for a CPU one).
- ``FlowConfig.pyr_impl``: ``'poly'`` (plain polyphase pyr_down),
  ``'cuda'`` (the pyr_down kernel) or ``'auto'`` (by the tensor's device).
- ``FlowConfig.warp_impl``: ``'gather'``, ``'shift'``, ``'shift_sep'`` or
  ``'auto'`` (``'shift_sep'`` for a CUDA tensor when ``warp_clamp`` is set,
  else ``'gather'``).

Nothing here switches a global backend: every choice is made per call from
the tensor's device. Where a user or a client may name ``impl`` in either
package's words (the server's handshake, the CLI's ``--impl``),
``impl_from_name`` reads the JAX package's ``'jnp'`` as ``'torch'`` and
``'pallas'`` as ``'cuda'``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# FlowConfig.impl by the names either package gives it
IMPL_NAMES = {"auto": "auto", "torch": "torch", "cuda": "cuda", "jnp": "torch", "pallas": "cuda"}


def impl_from_name(name: str) -> str:
    """The port's ``FlowConfig.impl`` for ``name``, a name of the port's or
    of the JAX package's (``'jnp'``, ``'pallas'``)."""
    try:
        return IMPL_NAMES[name]
    except KeyError:
        raise ValueError(f"unknown impl {name!r} (want one of {', '.join(IMPL_NAMES)})") from None


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Dense pyramidal Lucas–Kanade configuration (defaults: the reference
    semantics, LKof.cpp:152-228)."""

    # Pyramid levels. None -> max_pyramid_levels(shape).
    levels: Optional[int] = None
    # Quantize warp fractions to 1/32 like OpenCV remap's fixed point.
    quantize_warp: bool = True
    # 'torch' | 'cuda' | 'auto' (see module docstring).
    impl: str = "auto"
    # Clamp on the per-level flow used for warping (None = unbounded).
    warp_clamp: Optional[float] = None
    # Warp-and-solve passes per level; > 1 requires mode='corrected'.
    level_iters: int = 1
    # 'gather' | 'shift' | 'shift_sep' | 'auto'; the shift forms require warp_clamp.
    warp_impl: str = "auto"
    # 'poly' | 'cuda' | 'auto'.
    pyr_impl: str = "poly"
    # 'reference' (flow not doubled on pyrUp, the goldens' quantity) or
    # 'corrected' (displacement-true pyramidal LK).
    mode: str = "reference"


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Video frame preprocessing (ParallelVideoPyr.cpp:780-820)."""

    size: Tuple[int, int] = (1080, 1080)  # (height, width)
    blur_ksize: int = 9
    blur_sigma: float = 1.5
    learning_rate: float = 0.3
    diff_thresh: float = 10.0
    morph_iterations: int = 2
    # True: the reference's uint8 saturating chain; False: everything in
    # float32.
    faithful_uint8: bool = True


@dataclasses.dataclass(frozen=True)
class GestureConfig:
    """Gesture detection operating point (ParallelVideoPyr.cpp:845-890)."""

    mag_thresh: float = 20.0
    min_votes: int = 500
    circle_radius: int = 35
    norm_alpha: float = 255.0


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    preprocess: PreprocessConfig = PreprocessConfig()
    flow: FlowConfig = FlowConfig()
    gesture: GestureConfig = GestureConfig()

    @classmethod
    def fast(cls, size=(1080, 1080)) -> "VideoConfig":
        """Production-throughput preset: float preprocess, corrected-mode
        pyramid with the clamped separable warp, streaming pyramid reuse."""
        return cls(
            preprocess=PreprocessConfig(size=size, faithful_uint8=False),
            flow=FlowConfig(
                mode="corrected", warp_clamp=8.0, warp_impl="auto",
                pyr_impl="auto",
            ),
            faithful_prev_diff=False,
        )

    # True keeps the reference's warped diff as the next prevDiff
    # (ParallelVideoPyr.cpp:841); False keeps the unwarped diff.
    faithful_prev_diff: bool = True
    # Frames processed together as a batch.
    batch: int = 1


def video_config_for(preset: str, proc_size: Tuple[int, int], impl: str = "auto") -> VideoConfig:
    """The VideoConfig of a named preset, as the server's handshake and the
    ``video`` CLI name it: ``'fast'`` is ``VideoConfig.fast(size=proc_size)``
    with only ``impl`` replaced (every other knob stays the preset's);
    ``'faithful'`` is the reference-parity ``VideoConfig()`` at
    ``proc_size``. ``impl`` takes either package's names."""
    impl = impl_from_name(impl)
    if preset == "fast":
        cfg = VideoConfig.fast(size=proc_size)
        if impl != "auto":
            cfg = dataclasses.replace(cfg, flow=dataclasses.replace(cfg.flow, impl=impl))
        return cfg
    if preset == "faithful":
        return VideoConfig(
            preprocess=PreprocessConfig(size=proc_size),
            flow=FlowConfig(impl=impl),
        )
    raise ValueError(f"unknown preset {preset!r} (want 'fast' or 'faithful')")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for spatial tiling and frame parallelism
    (parallel/mesh.py): rows/cols tile each image, frames splits a batch
    of frame pairs."""

    rows: int = 1
    cols: int = 1
    frames: int = 1
    axis_rows: str = "rows"
    axis_cols: str = "cols"
    axis_frames: str = "frames"
