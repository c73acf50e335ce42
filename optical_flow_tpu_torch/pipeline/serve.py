"""Network serving for the streaming flow/gesture pipeline (port of
optical_flow_tpu/pipeline/serve.py, wire protocol version 1 byte for byte:
a client of either package works against a server of either).

The reference's deployment modality is a LIVE process — an interactive
webcam loop where the warmed-up pipeline stays resident between frames
(ParallelVideoPyr.cpp:730-905). Here that is a serving process that owns
the card and answers frame streams over a socket. Per-connection streams
check pipelines out of a keyed pool, so each (preset, shape, impl) builds
its pipeline once for the life of the server, not once per client: a
pooled pipeline keeps its resize operator and the CUDA graphs of its
steady step (pipeline/graphs.py), and the next stream of that key replays
them. One device lock serializes every touch of the card: the push, the
gesture's scalars and the flow's copy to the host (one accelerator, many
clients; a graph capture of one stream never overlaps another stream's
work). Per-stream sequential state lives in the checked-out pipeline,
never shared.

Wire protocol (version 1; u32 lengths big-endian, pixel/flow payloads
little-endian C-order):

  client -> server   one newline-terminated JSON handshake:
      {"v": 1, "height": H, "width": W, "channels": C,
       "preset": "fast"|"faithful", "proc_height": h, "proc_width": w,
       "return_flow": bool, "impl": "auto"|"torch"|"cuda"|"jnp"|"pallas"}
    (proc_* default to 256x256 — the `video` CLI default; channels
    defaults to 3; the JAX package's impl names "jnp" and "pallas" are
    read as "torch" and "cuda".)
  server -> client   one JSON line {"ok": true, "pooled": bool} or
      {"ok": false, "error": "..."} followed by connection close.

  then, per frame:
    client: u32 length + raw H*W*C uint8 (BGR, like the file decoder)
    server: one JSON line —
        {"frame": i, "warmup": true}                   (first two frames;
          the reference needs one frame for prevFrame and one for
          prevDiff, ParallelVideoPyr.cpp:794-822)
        {"frame": i, "detected": b, "cx": x, "cy": y, "votes": n}
      followed, when return_flow was set and the frame is not warmup, by
        u32 length + float32 u then v (proc_h*proc_w values each).

  a zero-length frame ends the stream: the server replies
      {"end": true, "frames": N}
  and the connection returns to handshake state, so one connection can
  carry many streams. EOF at handshake state is a clean close.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from optical_flow_tpu_torch.config import VideoConfig, video_config_for
from optical_flow_tpu_torch.utils.device import canonical_device

PROTOCOL_VERSION = 1
# backstop against a corrupt length prefix allocating unbounded memory
MAX_FRAME_BYTES = 256 * 1024 * 1024
# backstop against handshake proc dims exhausting the server's memory (dense
# resize matrices are O(dim^2))
MAX_PROC_DIM = 4096
_U32 = struct.Struct(">I")


def _make_config(preset: str, proc_size: Tuple[int, int], impl: str) -> VideoConfig:
    """The handshake's preset, under the JAX package's name."""
    return video_config_for(preset, proc_size, impl)


class _PipelinePool:
    """Keyed free-list of VideoPipelines. acquire() reuses a built pipeline
    when one is idle (reset first — stream state is per client; its CUDA
    graphs stay), else builds a fresh one; release() returns it for the
    next stream.

    The free list is CAPPED per key: a burst of N concurrent same-key
    streams builds N pipelines, and an unbounded list would pin all N
    (their graphs' private memory included) for the server's life even
    though device_lock serializes pushes anyway. Releases beyond the cap
    are dropped."""

    MAX_FREE_PER_KEY = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict = {}

    def acquire(self, key, factory):
        with self._lock:
            free = self._free.get(key)
            pipe = free.pop() if free else None
        pooled = pipe is not None
        if pipe is None:
            pipe = factory()
        pipe.reset()
        return pipe, pooled

    def release(self, key, pipe) -> None:
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.MAX_FREE_PER_KEY:
                free.append(pipe)


class _StreamHandler(socketserver.StreamRequestHandler):
    """One client connection: a sequence of handshake-framed streams."""

    def handle(self):
        server: FlowServer = self.server.flow_server  # type: ignore[attr-defined]
        while True:
            line = self.rfile.readline(65536)
            if not line:
                return  # clean close at handshake state
            try:
                hs = json.loads(line)
                if int(hs.get("v", PROTOCOL_VERSION)) != PROTOCOL_VERSION:
                    raise ValueError(f"unsupported protocol version {hs.get('v')}")
                height = int(hs["height"])
                width = int(hs["width"])
                channels = int(hs.get("channels", 3))
                preset = str(hs.get("preset", "fast"))
                proc = (
                    int(hs.get("proc_height", 256)),
                    int(hs.get("proc_width", 256)),
                )
                return_flow = bool(hs.get("return_flow", False))
                impl = str(hs.get("impl", "auto"))
                if channels not in (1, 3, 4):
                    raise ValueError(f"unsupported channel count {channels}")
                # each dimension validated alone: negative height x
                # negative width multiplies to a positive product that
                # would pass a size-only check, then blow up in reshape
                # inside the handler thread
                if height <= 0 or width <= 0:
                    raise ValueError(f"bad frame dims {height}x{width}")
                # proc dims bounded too: the resize operator materializes
                # dense per-axis matrices, so an unbounded client value
                # would exhaust the long-running server's memory
                if not (0 < proc[0] <= MAX_PROC_DIM and 0 < proc[1] <= MAX_PROC_DIM):
                    raise ValueError(
                        f"bad proc dims {proc[0]}x{proc[1]} "
                        f"(each must be 1..{MAX_PROC_DIM})"
                    )
                frame_bytes = height * width * channels
                if frame_bytes > MAX_FRAME_BYTES:
                    raise ValueError(f"frame size {frame_bytes} out of range")
                cfg = _make_config(preset, proc, impl)
            except Exception as exc:  # malformed handshake: report and drop
                self._send_json({"ok": False, "error": str(exc)})
                return
            # keyed by the port's impl name: "pallas" and "cuda" share pipelines
            key = (preset, height, width, channels, proc, cfg.flow.impl)
            pipe, pooled = server.pool.acquire(key, lambda: server.make_pipeline(cfg))
            try:
                self._send_json({"ok": True, "pooled": pooled})
                frames = self._serve_stream(server, pipe, height, width, channels, return_flow)
            finally:
                server.pool.release(key, pipe)
            if frames is None:
                # the stream closed the socket (bad frame): re-entering the
                # handshake loop would readline() a closed file
                return
            # sent after the release: a client that has read the end reply
            # finds the pipeline back in the pool
            self._send_json({"end": True, "frames": frames})

    def _serve_stream(self, server, pipe, height, width, channels, return_flow) -> Optional[int]:
        """Serve one stream up to its zero-length frame; returns the frames
        served, or None when the connection is dead (the caller must return
        instead of awaiting another handshake)."""
        frame_bytes = height * width * channels
        shape = (height, width) if channels == 1 else (height, width, channels)
        n = 0
        while True:
            head = self.rfile.read(_U32.size)
            if len(head) < _U32.size:
                return None  # peer vanished mid-stream; pool still reclaims
            (length,) = _U32.unpack(head)
            if length == 0:
                return n
            if length != frame_bytes:
                self._send_json(
                    {"ok": False, "error": f"frame payload {length} B, expected {frame_bytes}"}
                )
                self.connection.close()
                return None
            payload = self.rfile.read(length)
            if len(payload) < length:
                return None
            # read-only view of the payload: the pipeline's upload copies it
            frame = np.frombuffer(payload, dtype=np.uint8).reshape(shape)
            reply, flows = server.step(pipe, frame, n, return_flow)
            n += 1
            self._send_json(reply)
            if flows is not None:
                self.wfile.write(_U32.pack(flows.nbytes))
                self.wfile.write(memoryview(flows).cast("B"))
                self.wfile.flush()

    def _send_json(self, obj) -> None:
        self.wfile.write(json.dumps(obj).encode() + b"\n")
        self.wfile.flush()


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


if hasattr(socketserver, "ThreadingUnixStreamServer"):

    class _UnixServer(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

else:  # platform without AF_UNIX
    _UnixServer = None  # type: ignore[assignment]


class FlowServer:
    """Long-running flow/gesture server over TCP or a Unix socket.

    Its pipelines run on ``device``, the card unless another device is
    named (``device="cpu"``); without a card it raises. ``mesh``: a
    ``parallel.flow_mesh`` whose home device is ``device``; every stream's
    flow is then tiled over it.

    >>> srv = FlowServer(port=0); srv.start_background()
    >>> # ... FlowClient(srv.address) streams frames ...
    >>> srv.shutdown()
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        unix_path: Optional[str] = None,
        mesh=None,
        device="cuda",
    ):
        self.device = canonical_device(device)
        self.pool = _PipelinePool()
        self.device_lock = threading.Lock()
        self._mesh = mesh
        if unix_path is not None:
            if _UnixServer is None:
                raise OSError("AF_UNIX sockets unavailable on this platform")
            self._server = _UnixServer(unix_path, _StreamHandler)
            self.address: Union[str, Tuple[str, int]] = unix_path
        else:
            self._server = _TCPServer((host, port), _StreamHandler)
            self.address = self._server.server_address[:2]
        self._server.flow_server = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._served = False

    def make_pipeline(self, cfg: VideoConfig):
        from optical_flow_tpu_torch.pipeline.video import VideoPipeline

        return VideoPipeline(cfg, device=self.device, mesh=self._mesh)

    def step(self, pipe, frame: np.ndarray, idx: int, return_flow: bool):
        """Push one frame of a stream: (its JSON reply, the host flows (2, h,
        w) float32 or None). Everything that touches the card — the push,
        the gesture's scalars, the flow's copy to the host — runs under the
        device lock."""
        with self.device_lock:
            result = pipe.push(frame)
            if result is None:
                return {"frame": idx, "warmup": True}, None
            g = result.gesture
            detected, cx, cy, votes = torch.stack(
                [g.detected.double(), g.cx.double(), g.cy.double(), g.votes.double()]
            ).tolist()
            flows = (
                torch.stack([result.u, result.v]).to(torch.float32).cpu().numpy()
                if return_flow else None
            )
        reply = {"frame": idx, "detected": bool(detected), "cx": cx, "cy": cy,
                 "votes": int(votes)}
        return reply, flows

    def serve_forever(self) -> None:
        self._served = True
        self._server.serve_forever()

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        if self._served:  # socketserver's shutdown waits for a loop that never ran
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)


class FlowClient:
    """Minimal client for FlowServer's wire protocol (tests + examples).

    address: ("host", port) tuple, or a Unix-socket path string.
    """

    def __init__(self, address: Union[str, Tuple[str, int]], timeout: float = 120.0):
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            address = tuple(address)  # type: ignore[assignment]
        self._sock.settimeout(timeout)
        self._sock.connect(address)
        self._rfile = self._sock.makefile("rb")
        self._return_flow = False
        self._proc: Tuple[int, int] = (256, 256)

    def start_stream(
        self,
        height: int,
        width: int,
        channels: int = 3,
        preset: str = "fast",
        proc_size: Tuple[int, int] = (256, 256),
        return_flow: bool = False,
        impl: str = "auto",
    ) -> dict:
        self._return_flow = return_flow
        self._proc = tuple(proc_size)  # type: ignore[assignment]
        hs = {
            "v": PROTOCOL_VERSION,
            "height": height,
            "width": width,
            "channels": channels,
            "preset": preset,
            "proc_height": proc_size[0],
            "proc_width": proc_size[1],
            "return_flow": return_flow,
            "impl": impl,
        }
        self._sock.sendall(json.dumps(hs).encode() + b"\n")
        return self._read_json()

    def push(self, frame: np.ndarray) -> dict:
        """Send one frame; returns the response dict, with 'u'/'v' float32
        arrays attached when the stream was started with return_flow."""
        payload = np.ascontiguousarray(frame, dtype=np.uint8).tobytes()
        self._sock.sendall(_U32.pack(len(payload)) + payload)
        resp = self._read_json()
        if (
            self._return_flow
            and resp.get("ok", True)
            and not resp.get("warmup", False)
            and "frame" in resp
        ):
            blob = self._read_blob()
            h, w = self._proc
            flows = np.frombuffer(blob, dtype=np.float32).reshape(2, h, w)
            resp["u"], resp["v"] = flows[0], flows[1]
        return resp

    def end_stream(self) -> dict:
        self._sock.sendall(_U32.pack(0))
        return self._read_json()

    def close(self) -> None:
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_json(self) -> dict:
        line = self._rfile.readline(65536)
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def _read_blob(self) -> bytes:
        head = self._rfile.read(_U32.size)
        if len(head) < _U32.size:
            raise ConnectionError("server closed mid-payload")
        (length,) = _U32.unpack(head)
        blob = self._rfile.read(length)
        if len(blob) < length:
            raise ConnectionError("server closed mid-payload")
        return blob
