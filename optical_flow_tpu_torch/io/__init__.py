"""Host-side IO: video decode and frame feeding (port of optical_flow_tpu/io).

Decode stays on the host: a rawvideo pipe, an ffmpeg subprocess or cv2
(``video_reader``). A background prefetcher stages the next frames on the
card through pinned memory and a copy stream of its own, so decode and the
upload overlap the card's work (``prefetch``). Annotated frames go to a
video file or PNGs (``video_writer``) and to a live MJPEG stream over HTTP
(``preview``).
"""

from optical_flow_tpu_torch.io.video_reader import VideoReader, read_frames
from optical_flow_tpu_torch.io.prefetch import prefetch_to_device

__all__ = ["VideoReader", "read_frames", "prefetch_to_device"]
