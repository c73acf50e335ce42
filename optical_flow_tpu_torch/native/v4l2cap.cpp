// Native V4L2 camera capture of the flow engine (the PyTorch port's copy
// of optical_flow_tpu/native/v4l2cap.cpp; the code below is the same).
//
// The reference's flagship and both sparse demos capture a live webcam
// (cv::VideoCapture(0): ParallelVideoPyr.cpp:737, of.cpp:45). libavdevice
// is not linkable in this toolchain, so this speaks the V4L2 kernel API
// directly (ioctl + mmap streaming ring — the same machinery OpenCV's
// V4L2 backend uses) and converts whatever pixel format the driver
// negotiates to BGR24 / GRAY8 with libswscale (already linked for the
// file decoder); MJPEG cameras decode through libavcodec.
//
// API is plain C for ctypes (see native/__init__.py::NativeCamera):
//   cam_open(dev, gray, &w, &h, &fps) -> handle | NULL
//   cam_next(handle, out)             -> 1 frame written | 0 failure
//   cam_close(handle)
//
// Build: compiled with framepipe.cpp into one library (native/__init__.py).

#ifndef __linux__
// V4L2 is Linux-only; on other platforms stub the C API so the shared
// library (file decoder + golden IO, both platform-agnostic) still
// builds — losing only the camera feature, not the whole native module.
extern "C" {
void* cam_open(const char*, int, int*, int*, double*) { return nullptr; }
int cam_next(void*, char*) { return 0; }
void cam_close(void*) {}
}
#else

#include <cerrno>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <linux/videodev2.h>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

constexpr int kRingBuffers = 4;

struct CamBuf {
  void* ptr = nullptr;
  size_t len = 0;
};

struct Camera {
  int fd = -1;
  int width = 0;
  int height = 0;
  int stride = 0;  // driver row stride (fmt.fmt.pix.bytesperline)
  double fps = 0.0;
  bool gray = false;
  uint32_t fourcc = 0;
  CamBuf bufs[kRingBuffers];
  int nbufs = 0;
  bool streaming = false;
  SwsContext* sws = nullptr;
  // MJPEG path
  AVCodecContext* mjpeg = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
};

int xioctl(int fd, unsigned long req, void* arg) {
  int r;
  do {
    r = ioctl(fd, req, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}

AVPixelFormat fourcc_to_avfmt(uint32_t f) {
  switch (f) {
    case V4L2_PIX_FMT_YUYV: return AV_PIX_FMT_YUYV422;
    case V4L2_PIX_FMT_UYVY: return AV_PIX_FMT_UYVY422;
    case V4L2_PIX_FMT_RGB24: return AV_PIX_FMT_RGB24;
    case V4L2_PIX_FMT_BGR24: return AV_PIX_FMT_BGR24;
    case V4L2_PIX_FMT_GREY: return AV_PIX_FMT_GRAY8;
    case V4L2_PIX_FMT_NV12: return AV_PIX_FMT_NV12;
    case V4L2_PIX_FMT_YUV420: return AV_PIX_FMT_YUV420P;
    default: return AV_PIX_FMT_NONE;
  }
}

void cam_free(Camera* c) {
  if (c == nullptr) return;
  if (c->streaming) {
    v4l2_buf_type t = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    xioctl(c->fd, VIDIOC_STREAMOFF, &t);
  }
  for (int i = 0; i < c->nbufs; ++i)
    if (c->bufs[i].ptr) munmap(c->bufs[i].ptr, c->bufs[i].len);
  if (c->fd >= 0) close(c->fd);
  if (c->sws) sws_freeContext(c->sws);
  if (c->mjpeg) avcodec_free_context(&c->mjpeg);
  if (c->frame) av_frame_free(&c->frame);
  if (c->pkt) av_packet_free(&c->pkt);
  delete c;
}

// convert one raw capture buffer into out (BGR24 or GRAY8, tight rows)
bool convert(Camera* c, const uint8_t* data, size_t len, uint8_t* out) {
  const AVPixelFormat dst_fmt = c->gray ? AV_PIX_FMT_GRAY8 : AV_PIX_FMT_BGR24;
  uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
  int dst_stride[4] = {c->gray ? c->width : 3 * c->width, 0, 0, 0};

  if (c->fourcc == V4L2_PIX_FMT_MJPEG || c->fourcc == V4L2_PIX_FMT_JPEG) {
    c->pkt->data = const_cast<uint8_t*>(data);
    c->pkt->size = static_cast<int>(len);
    if (avcodec_send_packet(c->mjpeg, c->pkt) < 0) return false;
    if (avcodec_receive_frame(c->mjpeg, c->frame) < 0) return false;
    c->sws = sws_getCachedContext(
        c->sws, c->frame->width, c->frame->height,
        static_cast<AVPixelFormat>(c->frame->format), c->width, c->height,
        dst_fmt, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (c->sws == nullptr) return false;
    sws_scale(c->sws, c->frame->data, c->frame->linesize, 0, c->frame->height,
              dst, dst_stride);
    av_frame_unref(c->frame);
    return true;
  }

  const AVPixelFormat src_fmt = fourcc_to_avfmt(c->fourcc);
  if (src_fmt == AV_PIX_FMT_NONE) return false;
  uint8_t* src[4];
  int src_stride[4];
  if (av_image_fill_arrays(src, src_stride, data, src_fmt, c->width,
                           c->height, 1) < 0)
    return false;
  // honor the driver's row stride: many drivers pad rows for alignment
  // (bytesperline > width*bpp), and fill_arrays' tight layout would read
  // every row sheared. Packed single-plane formats just take the real
  // stride; a PADDED planar layout would need per-plane offsets we can't
  // derive portably — fail cleanly instead of returning garbage.
  if (c->stride > src_stride[0]) {
    const bool packed = src_stride[1] == 0;
    if (!packed) return false;
    src_stride[0] = c->stride;
  }
  c->sws = sws_getCachedContext(c->sws, c->width, c->height, src_fmt,
                                c->width, c->height, dst_fmt, SWS_BILINEAR,
                                nullptr, nullptr, nullptr);
  if (c->sws == nullptr) return false;
  sws_scale(c->sws, src, src_stride, 0, c->height, dst, dst_stride);
  return true;
}

}  // namespace

extern "C" {

void* cam_open(const char* dev, int gray, int* w, int* h, double* fps) {
  Camera* c = new Camera();
  c->gray = gray != 0;
  c->fd = open(dev, O_RDWR | O_CLOEXEC);
  if (c->fd < 0) {
    cam_free(c);
    return nullptr;
  }

  v4l2_capability cap{};
  if (xioctl(c->fd, VIDIOC_QUERYCAP, &cap) < 0 ||
      !(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
      !(cap.capabilities & V4L2_CAP_STREAMING)) {
    cam_free(c);
    return nullptr;
  }

  // take the driver's current format; ask for YUYV only if the current
  // one is something swscale/avcodec can't handle
  v4l2_format fmt{};
  fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(c->fd, VIDIOC_G_FMT, &fmt) < 0) {
    cam_free(c);
    return nullptr;
  }
  uint32_t f = fmt.fmt.pix.pixelformat;
  if (fourcc_to_avfmt(f) == AV_PIX_FMT_NONE && f != V4L2_PIX_FMT_MJPEG &&
      f != V4L2_PIX_FMT_JPEG) {
    fmt.fmt.pix.pixelformat = V4L2_PIX_FMT_YUYV;
    if (xioctl(c->fd, VIDIOC_S_FMT, &fmt) < 0 ||
        fmt.fmt.pix.pixelformat != V4L2_PIX_FMT_YUYV) {
      cam_free(c);
      return nullptr;
    }
  }
  c->fourcc = fmt.fmt.pix.pixelformat;
  c->width = static_cast<int>(fmt.fmt.pix.width);
  c->height = static_cast<int>(fmt.fmt.pix.height);
  c->stride = static_cast<int>(fmt.fmt.pix.bytesperline);

  v4l2_streamparm parm{};
  parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(c->fd, VIDIOC_G_PARM, &parm) == 0 &&
      parm.parm.capture.timeperframe.numerator > 0)
    c->fps = static_cast<double>(parm.parm.capture.timeperframe.denominator) /
             parm.parm.capture.timeperframe.numerator;

  if (c->fourcc == V4L2_PIX_FMT_MJPEG || c->fourcc == V4L2_PIX_FMT_JPEG) {
    const AVCodec* dec = avcodec_find_decoder(AV_CODEC_ID_MJPEG);
    if (dec == nullptr) {
      cam_free(c);
      return nullptr;
    }
    c->mjpeg = avcodec_alloc_context3(dec);
    if (c->mjpeg == nullptr || avcodec_open2(c->mjpeg, dec, nullptr) < 0) {
      cam_free(c);
      return nullptr;
    }
    c->frame = av_frame_alloc();
    c->pkt = av_packet_alloc();
  }

  v4l2_requestbuffers req{};
  req.count = kRingBuffers;
  req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  req.memory = V4L2_MEMORY_MMAP;
  if (xioctl(c->fd, VIDIOC_REQBUFS, &req) < 0 || req.count < 1) {
    cam_free(c);
    return nullptr;
  }
  c->nbufs = static_cast<int>(req.count < kRingBuffers ? req.count
                                                       : kRingBuffers);
  for (int i = 0; i < c->nbufs; ++i) {
    v4l2_buffer b{};
    b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    b.memory = V4L2_MEMORY_MMAP;
    b.index = i;
    if (xioctl(c->fd, VIDIOC_QUERYBUF, &b) < 0) {
      cam_free(c);
      return nullptr;
    }
    c->bufs[i].len = b.length;
    c->bufs[i].ptr = mmap(nullptr, b.length, PROT_READ | PROT_WRITE,
                          MAP_SHARED, c->fd, b.m.offset);
    if (c->bufs[i].ptr == MAP_FAILED) {
      c->bufs[i].ptr = nullptr;
      cam_free(c);
      return nullptr;
    }
    if (xioctl(c->fd, VIDIOC_QBUF, &b) < 0) {
      cam_free(c);
      return nullptr;
    }
  }

  v4l2_buf_type t = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(c->fd, VIDIOC_STREAMON, &t) < 0) {
    cam_free(c);
    return nullptr;
  }
  c->streaming = true;
  *w = c->width;
  *h = c->height;
  *fps = c->fps;
  return c;
}

int cam_next(void* handle, char* out) {
  Camera* c = static_cast<Camera*>(handle);
  if (c == nullptr || !c->streaming) return 0;
  // a buffer dequeued with V4L2_BUF_FLAG_ERROR holds a corrupted capture
  // (USB transfer error): requeue it and try the next one instead of
  // converting junk bytes into a "good" frame (cv2's backend does the
  // same); bounded retries so a wedged driver can't spin forever
  for (int attempt = 0; attempt < 2 * kRingBuffers; ++attempt) {
    v4l2_buffer b{};
    b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    b.memory = V4L2_MEMORY_MMAP;
    if (xioctl(c->fd, VIDIOC_DQBUF, &b) < 0) return 0;
    if (b.flags & V4L2_BUF_FLAG_ERROR) {
      xioctl(c->fd, VIDIOC_QBUF, &b);
      continue;
    }
    const bool ok =
        convert(c, static_cast<const uint8_t*>(c->bufs[b.index].ptr),
                b.bytesused, reinterpret_cast<uint8_t*>(out));
    xioctl(c->fd, VIDIOC_QBUF, &b);  // requeue regardless
    return ok ? 1 : 0;
  }
  return 0;
}

void cam_close(void* handle) { cam_free(static_cast<Camera*>(handle)); }

}  // extern "C"

#endif  // __linux__
