"""Checkpoint / resume for streaming pipeline state (port of
optical_flow_tpu/utils/checkpoint.py, in the same on-disk format).

The reference has no checkpointing (SURVEY.md section 5: `saveMat` flow
dumps are the only persisted state). For long-running video/tracking jobs
the engine's resumable state is small and explicit — the warm-up frames
(prev_gray, prev_diff), tracker points, frame index — so checkpoints are a
flat npz of the state tree (keypath-flattened) plus its JSON metadata,
byte for byte the JAX package's format: a checkpoint written by either
package loads in the other. Tensors (on any device) are written as host
copies and load as numpy arrays; ``VideoPipeline.restore`` puts them back
on the pipeline's device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np

from optical_flow_tpu_torch.utils.device import host_array

_META_KEY = "__optical_flow_tpu_meta__"


def _esc(key) -> str:
    """Escape path separators inside a dict key so the flattened keypath
    is INJECTIVE: without it {'a': {'b': 1}, 'a.b': 2} flattened to the
    same 'root.a.b' and silently corrupted the checkpoint (round-5
    review)."""
    return str(key).replace("\\", "\\\\").replace(".", "\\.").replace("[", "\\[")


def _flatten(prefix: str, obj: Any, out: Dict[str, np.ndarray], meta: Dict[str, Any]):
    if obj is None:
        meta[prefix] = "none"
    elif isinstance(obj, dict):
        meta[prefix] = {"kind": "dict", "keys": sorted(obj.keys())}
        for k in sorted(obj.keys()):
            _flatten(f"{prefix}.{_esc(k)}", obj[k], out, meta)
    elif isinstance(obj, (list, tuple)):
        meta[prefix] = {"kind": type(obj).__name__, "len": len(obj)}
        for i, v in enumerate(obj):
            _flatten(f"{prefix}[{i}]", v, out, meta)
    elif isinstance(obj, (int, float, bool, str)):
        meta[prefix] = {"kind": "scalar", "value": obj}
    else:  # array-like (numpy, or a tensor on any device)
        meta[prefix] = "array"
        out[prefix] = host_array(obj)


def _unflatten(prefix: str, arrays, meta):
    m = meta[prefix]
    if m == "none":
        return None
    if m == "array":
        return arrays[prefix]
    kind = m["kind"]
    if kind == "dict":
        def child(k):
            p = f"{prefix}.{_esc(k)}"
            if p in meta:
                return p
            # pre-escaping checkpoints stored separator-bearing keys
            # unescaped; fall back so old files keep loading
            return f"{prefix}.{k}"
        return {k: _unflatten(child(k), arrays, meta) for k in m["keys"]}
    if kind in ("list", "tuple"):
        items = [_unflatten(f"{prefix}[{i}]", arrays, meta) for i in range(m["len"])]
        return items if kind == "list" else tuple(items)
    if kind == "scalar":
        return m["value"]
    raise ValueError(f"bad checkpoint meta at {prefix}: {m}")


def save_state(path, state: Any) -> None:
    """Write a tree of arrays or tensors, scalars, None, dicts and lists to
    one .npz file."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    _flatten("root", state, arrays, meta)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)  # atomic on POSIX


def load_state(path) -> Any:
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
    return _unflatten("root", arrays, meta)
