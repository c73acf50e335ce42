"""Kernel timing and rooflines on the card (port of the parts of
optical_flow_tpu/utils/profiling.py that the kernel tables need).

- ``time_use_once``: device ms per call from CUDA events over many
  back-to-back launches, each on inputs used once. The launches are queued
  behind a device sleep, so the device runs them without waiting on the
  host even where one call is shorter than a launch's host cost.
- ``kernel_cost``: the bytes and operations of one call of a kernel, from
  its tensors and shapes. Each input byte is counted read once and each
  output byte written once; the operations are counted from the kernel's
  source, per output position (``OPS_PER_OUTPUT``). ``colsum_cost`` counts
  only the inputs S3's window reads.
- ``stage_roofline``: the least time the card could take for that work, the
  larger of bytes over the memory rate and operations over the rate for
  their type, against the H100's published peaks (``H100``); where given,
  also the time at the rates the probes sustained on the card (S2's copy
  rate, S4's float32 elementwise rate, both at a size that fills the card).

A timing without a card raises: no number of this module comes from the
CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence

import torch

# NVIDIA H100 SXM, dense, at the 700 W power limit: the HBM3 rate (data
# sheet) and the rates outside the tensor cores by operand type (data sheet
# for float32; H100 architecture white paper for bfloat16).
H100 = {"bytes_per_s": 3.35e12, "ops_per_s": {torch.float32: 67e12, torch.bfloat16: 133.8e12}}

# Operations per output position, counted from each kernel's source (every
# multiply, add, compare, clip, floor, rint and divide is one).
OPS_PER_OUTPUT = {
    # 2x2 gradients of two frames 21, five products 5, five 3x3 sums 40,
    # the Cramer solve 11; per (u, v) position
    "lk": 77,
    # vertical 5-tap at the kept rows (two input columns per output) 18,
    # horizontal 5-tap 9
    "pyrdown": 27,
    # the same per output of every level below the input: cost a pyramid as
    # kernel_cost("pyramid", [input], levels, outputs_counted=<their sum>),
    # the input read once and each level written once (what the function
    # needs, whether or not a kernel reads a level back)
    "pyramid": 27,
    # per output value of one plane: the row pass (8 per coarse pixel and
    # column) and the column pass (16), over 4 outputs per coarse pixel
    "pyrup": 6,
    # per fine (u, v) position: pyrUp of two planes 12, doubling 2, clip,
    # negate and 1/32 quantization of two planes 16, the 2-tap separable
    # warp of two frames 24, LK 77, the accumulation 2
    "pyrup_warp_lk": 133,
    # clip, negate and quantization 18, warp 24, LK 77
    "warp_lk": 119,
    "copy": 0,
    "interleave": 0,
    # 12 taps, a multiply and an add each, per windowed output
    "colsum": 24,
}


class Cost(NamedTuple):
    bytes: float
    ops: float


def io_bytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cost(kind: str, inputs: Sequence[torch.Tensor], outputs: Sequence[torch.Tensor], *,
                outputs_counted: Optional[int] = None) -> Cost:
    """Bytes and operations of one call of kernel ``kind``. The operations
    are ``OPS_PER_OUTPUT[kind]`` per element of the first output, or per
    ``outputs_counted`` positions where that differs (every level of a
    pyramid)."""
    n = outputs[0].numel() if outputs_counted is None else outputs_counted
    return Cost(float(io_bytes(list(inputs) + list(outputs))), float(OPS_PER_OUTPUT[kind]) * n)


def colsum_cost(shape: Sequence[int], win: int) -> Cost:
    """Bytes and operations of one S3 call on a float32 input of ``shape``:
    only the window's inputs, ``x[..., 1 : win + 12]``, are read; every
    output is written."""
    W = shape[-1]
    rows = 1
    for n in shape[:-1]:
        rows *= n
    read = win + 11 if win else 0
    return Cost(4.0 * rows * (read + W), float(OPS_PER_OUTPUT["colsum"]) * rows * win)


def stage_roofline(cost: Cost, ms: Optional[float] = None, *, dtype: torch.dtype = torch.float32,
                   rates: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """The least time the card could take for ``cost``, whose operations
    are on ``dtype``, and what bounds it, against the published peaks. With
    ``rates`` (``bytes_per_s`` and ``ops_per_s`` by type, as the probes
    sustained them), the time at those rates (``sustained_ms``). With ``ms``
    (a measured device time), the share of that time each one is."""
    out: Dict[str, object] = {"bytes": cost.bytes, "ops": cost.ops}
    for tag, r in (("bound", H100), ("sustained", rates)):
        if r is None:
            continue
        t_bytes = cost.bytes / r["bytes_per_s"] * 1e3
        t_ops = cost.ops / r["ops_per_s"][dtype] * 1e3
        out[f"{tag}_ms"] = max(t_bytes, t_ops)
        out[f"{tag}_by"] = "bytes" if t_bytes >= t_ops else "operations"
        if ms:
            out[f"share_of_{tag}"] = max(t_bytes, t_ops) / ms
    return out


def _need_card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device timing needs a CUDA device, got {device}")
    return device


def time_use_once(fn: Callable, arg_sets: Sequence[tuple], device="cuda") -> float:
    """Device ms per call of ``fn(*args)``: one warm-up call on the first
    entry of ``arg_sets``, then one timed call on each of the others (make
    each entry fresh: use-once inputs).

    The device is held by a sleep while the host queues the timed calls
    between two CUDA events, so the events time the calls back to back. If
    the sleep ended before the host had queued them all (the device would
    have waited on the host between calls), the measurement is taken again
    with a sleep twice as long. The card's launch queue holds about a
    thousand launches and the host waits once it is full, so keep the timed
    calls' launches below that.
    """
    device = _need_card(device)
    with torch.cuda.device(device):
        fn(*arg_sets[0])
        torch.cuda.synchronize()
        timed = arg_sets[1:]
        if not timed:
            raise ValueError("time_use_once needs a warm-up entry and at least one timed entry")
        sleep_ms = max(5.0, 0.1 * len(timed))
        # the SM clock in kHz = cycles per ms (the retries cover a wrong guess)
        cycles_per_ms = getattr(torch.cuda.get_device_properties(device), "clock_rate", 0) or 2e6
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            woke = torch.cuda.Event()
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            woke.record()
            start.record()
            t0 = time.perf_counter()
            for args in timed:
                fn(*args)
            end.record()
            queued_ms = (time.perf_counter() - t0) * 1e3
            held = not woke.query()
            end.synchronize()
            if held:
                return start.elapsed_time(end) / len(timed)
            sleep_ms = 2 * max(sleep_ms, queued_ms)
    raise RuntimeError("time_use_once: the host never queued the calls within the device sleep "
                       "(more launches than the launch queue holds?)")
