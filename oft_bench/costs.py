"""The yardstick of the kernels' rooflines: bytes and operations of each
kernel's function, and the H100's published peaks.

A frozen copy of ``optical_flow_tpu_torch/utils/profiling.py``'s
``H100``, ``OPS_PER_OUTPUT``, ``kernel_cost`` (here ``shape_cost``) and the bound of
``stage_roofline``, so that a change to the program cannot move it. Each
input byte is counted read once and each output byte written once; the
operations are counted per output position from the kernels' sources.

``frame_work`` lists the kernel work of one frame pair of a configuration
at its shapes: what the frame's functions need (the pyramid, LK at each
level, the fused steps), not what an implementation reads again. A later
implementation of the same frame is held to the same work.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

# The port's hand-written kernels (``kernels/csrc``) by the names the
# profiler gives them: K1, K2, K3/K4, S1, P1. Every reader that tells the
# port's kernels from the rest takes them from here.
PORT_KERNELS = ("lk_strip_kernel", "pyrdown_kernel", "warp_lk_kernel", "pyrup_strip_kernel",
                "tile_copy")
# cuBLAS's matrix products, by the names of their kernels
GEMM = re.compile(r"gemm|gemv|cublas|cutlass|xmma|splitKreduce", re.IGNORECASE)


def is_port_kernel(name: str) -> bool:
    return any(p in name for p in PORT_KERNELS)

# NVIDIA H100 SXM, dense, at the 700 W power limit: the HBM3 rate (data
# sheet) and the float32 rate outside the tensor cores (data sheet).
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

# Operations per output position, counted from each kernel's source (every
# multiply, add, compare, clip, floor, rint and divide is one).
OPS_PER_OUTPUT = {
    "lk": 77,
    "pyrdown": 27,
    "pyramid": 27,
    "pyrup": 6,
    "pyrup_warp_lk": 133,
    "warp_lk": 119,
    "copy": 0,
    "interleave": 0,
    "colsum": 24,
}


class Cost(NamedTuple):
    bytes: float
    ops: float


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def shape_cost(kind: str, inputs: Iterable[Sequence[int]], outputs: Sequence[Sequence[int]], *,
               outputs_counted: Optional[int] = None, itemsize: int = 4) -> Cost:
    """Bytes and operations of one call of kernel ``kind`` on float32
    tensors of these shapes (the program's ``kernel_cost``): every input and
    output byte once, ``OPS_PER_OUTPUT[kind]`` per element of the first
    output, or per ``outputs_counted`` positions (every level of a
    pyramid)."""
    shapes = list(inputs) + list(outputs)
    n = _numel(outputs[0]) if outputs_counted is None else outputs_counted
    return Cost(float(itemsize * sum(_numel(s) for s in shapes)),
                float(OPS_PER_OUTPUT[kind]) * n)


def bound_s(cost: Cost) -> float:
    """The least time the card could take for ``cost``: the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    return max(cost.bytes / H100_BYTES_PER_S, cost.ops / H100_F32_OPS_PER_S)


def _levels(h: int, w: int) -> int:
    def v2_plus1(n):
        p = 1
        while n % (1 << p) == 0:
            p += 1
        return p

    return min(v2_plus1(w), v2_plus1(h))


def _level_shapes(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    out = [(h, w)]
    for _ in range(levels - 1):
        h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return out


def frame_work(video: Dict) -> List[Tuple[str, Tuple, Cost]]:
    """(kernel, shape, cost) of each kernel call one frame pair of the
    configuration ``video`` (a configuration file's ``video`` object) needs
    on the kernel route:

    - corrected mode with the clamped 'shift_sep' warp (the fast preset):
      the pyramid of the new diff (K2), LK at the coarsest level (K1), the
      pyrUp+warp+LK step at every finer level (K3);
    - reference mode: LK at every level (K1), pyrUp of (u, v) between
      levels (S1); the pyramids are plain.
    """
    h, w = (int(s) for s in video["preprocess"]["size"])
    flow = video["flow"]
    levels = flow["levels"] or _levels(h, w)
    shapes = _level_shapes(h, w, levels)
    out: List[Tuple[str, Tuple, Cost]] = []
    if flow["mode"] == "corrected":
        if flow["warp_clamp"] is None or flow["level_iters"] != 1:
            raise ValueError("frame_work costs the fast preset's corrected path only")
        below = shapes[1:]
        out.append(("pyramid", shapes[0], shape_cost(
            "pyramid", [shapes[0]], below, outputs_counted=sum(_numel(s) for s in below))))
        c = shapes[-1]
        out.append(("lk", c, shape_cost("lk", [c, c], [c, c])))
        for i in range(levels - 2, -1, -1):
            f, cs = shapes[i], shapes[i + 1]
            out.append(("pyrup_warp_lk", f, shape_cost("pyrup_warp_lk", [f, f, cs, cs], [f, f])))
        return out
    for i in range(levels - 1, -1, -1):
        f = shapes[i]
        out.append(("lk", f, shape_cost("lk", [f, f], [f, f])))
        if i > 0:
            cs, up = f, (2 * f[0], 2 * f[1])
            out.append(("pyrup", cs, shape_cost("pyrup", [cs, cs], [up, up])))
    return out


def frame_bound_s(video: Dict, kinds: Optional[Iterable[str]] = None) -> float:
    """Seconds of bound of one frame pair's kernel work, over ``kinds``
    (every kernel where None)."""
    keep = None if kinds is None else set(kinds)
    return sum(bound_s(c) for k, _, c in frame_work(video) if keep is None or k in keep)
