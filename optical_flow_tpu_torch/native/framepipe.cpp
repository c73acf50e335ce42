// Native host runtime of the flow engine (the PyTorch port's copy of
// optical_flow_tpu/native/framepipe.cpp; the code below is the same).
//
// The reference's host-side native work is OpenCV's VideoCapture decode and
// saveMat/golden-file text IO (ParallelVideoPyr.cpp:737, LKof.cpp:139-150,
// serialOrig.cpp:575-636). Here:
//
//   FramePipe  — video decode straight through libavformat/libavcodec with
//                libswscale BGR24 conversion, running on a background
//                pthread into a ring buffer so decode overlaps device
//                compute (SURVEY.md P6). The consumer (Python/ctypes) pops
//                frames without ever blocking on the codec.
//   gf_load /  — golden-file "%lf"-text matrix parse/serialize (strtod hot
//   gf_save      loop; ~20x numpy.loadtxt on the 448x640 goldens).
//
// Build: optical_flow_tpu_torch/native/__init__.py compiles this file and
// v4l2cap.cpp with g++ into build/native/ at first use.
// API is plain C for ctypes.

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <pthread.h>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

// ---------------------------------------------------------------- decoder

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int stream = -1;
  int width = 0;
  int height = 0;
  double fps = 0.0;
  bool gray = false;  // GRAY8 output (1 byte/px): one sws YUV->gray pass
                      // instead of YUV->BGR24, and a third of the bytes
                      // crossing host->device (PCIe or tunnel) when the
                      // consumer is the fast (gray-first) preprocess
  bool draining = false;
  bool have_pending = false;  // pkt holds data the codec hasn't accepted yet
  bool skipping = false;      // discarding pre-seek-target frames
  bool seek_pts_seen = true;  // false: a pts-less frame ended the skip, so
                              // the post-seek position is the KEYFRAME,
                              // not the requested index — callers must
                              // fall back to decode-and-skip
  int64_t target_pts = 0;     // first wanted pts after a seek (stream tb)
  int64_t half_dur = 0;       // half a frame duration for the pts gate

  ~Decoder() {
    if (sws) sws_freeContext(sws);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  bool open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return false;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return false;
    const AVCodec* dec = nullptr;
    stream = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (stream < 0 || !dec) return false;
    codec = avcodec_alloc_context3(dec);
    if (!codec) return false;
    if (avcodec_parameters_to_context(codec, fmt->streams[stream]->codecpar) < 0)
      return false;
    // Multi-threaded software decode: frame threading where the codec
    // supports it (H.264/HEVC/VP9 do), slice threading otherwise.
    // thread_count 0 = one worker per core; override with
    // OPTICAL_FLOW_DECODE_THREADS (1 = the old single-threaded decode).
    // Threaded decode is bit-exact (verified vs the single-threaded
    // output in tests/test_native.py); the ring buffer already absorbs
    // the frame-threading delay. This matters for multi-host frame-DP,
    // where per-host decode throughput is the scaling limit
    // (docs/SCALING.md; reference analogue: the OpenMP capture loop,
    // ParallelVideoPyr.cpp:736-760).
    const char* tenv = getenv("OPTICAL_FLOW_DECODE_THREADS");
    codec->thread_count = tenv ? atoi(tenv) : 0;
    codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (avcodec_open2(codec, dec, nullptr) < 0) return false;
    width = codec->width;
    height = codec->height;
    AVRational r = fmt->streams[stream]->avg_frame_rate;
    fps = r.den ? static_cast<double>(r.num) / r.den : 0.0;
    frame = av_frame_alloc();
    pkt = av_packet_alloc();
    return frame && pkt && width > 0 && height > 0;
  }

  // Frame-accurate seek to frame index `idx`: av_seek_frame to the last
  // keyframe at/before the target timestamp, flush the codec, then decode
  // and DISCARD until the target pts (OpticalFlowDemo.cpp scrubbing, but
  // container-seek fast instead of decode-from-zero). false if the
  // container/stream can't seek by timestamp.
  bool seek_frame_index(long idx) {
    if (idx <= 0) return true;
    AVStream* st = fmt->streams[stream];
    AVRational fr = st->avg_frame_rate;
    if (fr.num <= 0 || fr.den <= 0) return false;
    AVRational per_frame = {fr.den, fr.num};  // seconds per frame
    int64_t start =
        (st->start_time == AV_NOPTS_VALUE) ? 0 : st->start_time;
    target_pts = start + av_rescale_q(idx, per_frame, st->time_base);
    half_dur = av_rescale_q(1, per_frame, st->time_base) / 2;
    if (av_seek_frame(fmt, stream, target_pts, AVSEEK_FLAG_BACKWARD) < 0)
      return false;
    avcodec_flush_buffers(codec);
    draining = false;
    have_pending = false;
    skipping = true;
    return true;
  }

  // Decode the next frame into out (height x width x 3 BGR24). 1/0.
  int next(unsigned char* out) {
    for (;;) {
      int rc = avcodec_receive_frame(codec, frame);
      if (rc == 0) {
        if (skipping) {
          int64_t pts = frame->best_effort_timestamp;
          if (pts == AV_NOPTS_VALUE) {
            // pts-less stream: the post-seek position is unknowable —
            // record it so fp_open_fmt fails the seek and the Python
            // caller decode-skips from frame 0 (exact for any codec)
            seek_pts_seen = false;
            skipping = false;
          } else if (pts + half_dur < target_pts) {
            av_frame_unref(frame);
            continue;
          } else {
            skipping = false;
          }
        }
        // per-frame cached context: a mid-stream format/geometry change
        // (new SPS, yuv420p->yuvj420p) must re-create the scaler, not
        // convert with a stale descriptor (same pattern as v4l2cap.cpp)
        sws = sws_getCachedContext(
            sws, frame->width, frame->height, (AVPixelFormat)frame->format,
            width, height, gray ? AV_PIX_FMT_GRAY8 : AV_PIX_FMT_BGR24,
            SWS_BILINEAR, nullptr, nullptr, nullptr);
        if (!sws) return 0;
        uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
        int dst_stride[4] = {(gray ? 1 : 3) * width, 0, 0, 0};
        sws_scale(sws, frame->data, frame->linesize, 0, frame->height, dst,
                  dst_stride);
        av_frame_unref(frame);
        return 1;
      }
      if (rc == AVERROR_EOF) return 0;
      if (rc != AVERROR(EAGAIN)) return 0;
      if (draining) return 0;
      // The codec wants input. Read the next packet of our stream unless
      // one is still pending from a previous EAGAIN on send.
      while (!have_pending) {
        int rr = av_read_frame(fmt, pkt);
        if (rr < 0) {
          draining = true;
          avcodec_send_packet(codec, nullptr);  // flush
          break;
        }
        if (pkt->stream_index == stream) {
          have_pending = true;
        } else {
          av_packet_unref(pkt);
        }
      }
      if (have_pending) {
        int sc = avcodec_send_packet(codec, pkt);
        if (sc == 0) {
          av_packet_unref(pkt);
          have_pending = false;
        } else if (sc != AVERROR(EAGAIN)) {
          av_packet_unref(pkt);
          have_pending = false;
          return 0;
        }
        // EAGAIN: keep the packet; drain receive_frame first, retry send.
      }
    }
  }
};

// ------------------------------------------------------------- ring buffer

struct Ring {
  std::vector<unsigned char> data;  // capacity * frame_bytes
  size_t frame_bytes = 0;
  int capacity = 0;
  int head = 0;   // next slot to write
  int tail = 0;   // next slot to read
  int count = 0;  // filled slots
  bool eof = false;
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
  pthread_cond_t can_put = PTHREAD_COND_INITIALIZER;
  pthread_cond_t can_get = PTHREAD_COND_INITIALIZER;
};

struct FramePipe {
  Decoder dec;
  pthread_t reader{};
  bool reader_started = false;
  bool stop = false;  // written/read ONLY under ring.mu (data-race-free)
  Ring ring;
  // first frame decoded synchronously in fp_open_fmt (seek validation);
  // the reader thread pushes it into the ring before the decode loop
  std::vector<unsigned char> first_frame;
  bool have_first = false;
};

bool stop_requested(FramePipe* fp) {
  pthread_mutex_lock(&fp->ring.mu);
  bool s = fp->stop;
  pthread_mutex_unlock(&fp->ring.mu);
  return s;
}

// blocking ring insert; false when the pipe is stopping
bool ring_push(FramePipe* fp, const unsigned char* src) {
  Ring& rb = fp->ring;
  pthread_mutex_lock(&rb.mu);
  while (rb.count == rb.capacity && !fp->stop) {
    pthread_cond_wait(&rb.can_put, &rb.mu);
  }
  if (fp->stop) {
    pthread_mutex_unlock(&rb.mu);
    return false;
  }
  memcpy(rb.data.data() + static_cast<size_t>(rb.head) * rb.frame_bytes, src,
         rb.frame_bytes);
  rb.head = (rb.head + 1) % rb.capacity;
  rb.count++;
  pthread_cond_signal(&rb.can_get);
  pthread_mutex_unlock(&rb.mu);
  return true;
}

void* reader_main(void* arg) {
  auto* fp = static_cast<FramePipe*>(arg);
  Ring& rb = fp->ring;
  std::vector<unsigned char> tmp(rb.frame_bytes);
  if (fp->have_first) {
    if (ring_push(fp, fp->first_frame.data())) fp->first_frame.clear();
  }
  while (!stop_requested(fp) && fp->dec.next(tmp.data())) {
    if (!ring_push(fp, tmp.data())) break;
  }
  pthread_mutex_lock(&rb.mu);
  rb.eof = true;
  pthread_cond_broadcast(&rb.can_get);
  pthread_mutex_unlock(&rb.mu);
  return nullptr;
}

}  // namespace

extern "C" {

// Open `path` at frame index `start_frame` (0 = beginning; >0 seeks the
// container: av_seek_frame to the preceding keyframe + decode-discard to
// the exact frame — NULL if the stream cannot seek, callers fall back to
// decode-and-skip). `gray` != 0 emits GRAY8 (h*w bytes/frame) instead of
// BGR24 (h*w*3). Writes stream geometry into the out params and starts
// the decode thread with `ring_capacity` frames of lookahead.
FramePipe* fp_open_fmt(const char* path, int ring_capacity, long start_frame,
                       int gray, int* out_w, int* out_h, double* out_fps) {
  if (ring_capacity <= 0) return nullptr;
  auto* fp = new FramePipe();
  fp->dec.gray = gray != 0;
  if (!fp->dec.open(path) ||
      (start_frame > 0 && !fp->dec.seek_frame_index(start_frame))) {
    delete fp;
    return nullptr;
  }
  if (out_w) *out_w = fp->dec.width;
  if (out_h) *out_h = fp->dec.height;
  if (out_fps) *out_fps = fp->dec.fps;
  fp->ring.frame_bytes = static_cast<size_t>(fp->dec.width) *
                         fp->dec.height * (gray ? 1 : 3);
  fp->ring.capacity = ring_capacity;
  fp->ring.data.resize(fp->ring.frame_bytes * ring_capacity);
  if (start_frame > 0) {
    // validate the seek BEFORE starting the thread: decode the first
    // post-skip frame synchronously; a pts-less stream stops skipping at
    // the KEYFRAME (position unknowable) — fail so the Python caller
    // decode-skips from zero instead of yielding mislabeled frames
    fp->first_frame.resize(fp->ring.frame_bytes);
    const bool got = fp->dec.next(fp->first_frame.data()) != 0;
    if (!fp->dec.seek_pts_seen) {
      delete fp;
      return nullptr;  // position unknowable: Python decode-skips exactly
    }
    // EOF after a VALID seek (start at/past the stream's end): an empty
    // stream is the correct answer — failing here would make the caller
    // decode the ENTIRE file just to discard everything
    fp->have_first = got;
  }
  if (pthread_create(&fp->reader, nullptr, reader_main, fp) != 0) {
    delete fp;
    return nullptr;
  }
  fp->reader_started = true;
  return fp;
}

// Back-compat wrappers (BGR24).
FramePipe* fp_open(const char* path, int ring_capacity, int* out_w, int* out_h,
                   double* out_fps) {
  return fp_open_fmt(path, ring_capacity, 0, 0, out_w, out_h, out_fps);
}

FramePipe* fp_open_at(const char* path, int ring_capacity, long start_frame,
                      int* out_w, int* out_h, double* out_fps) {
  return fp_open_fmt(path, ring_capacity, start_frame, 0, out_w, out_h,
                     out_fps);
}

// Geometry-only probe: open the container/codec headers, no decode
// thread, no frame decode. 0 on success, -1 on failure.
int fp_probe(const char* path, int* out_w, int* out_h, double* out_fps) {
  Decoder dec;
  if (!dec.open(path)) return -1;
  if (out_w) *out_w = dec.width;
  if (out_h) *out_h = dec.height;
  if (out_fps) *out_fps = dec.fps;
  return 0;
}

// Pop the next frame into out (h*w*3 bytes BGR). 1 = frame, 0 = end.
int fp_next(FramePipe* fp, unsigned char* out) {
  if (!fp) return 0;
  Ring& rb = fp->ring;
  pthread_mutex_lock(&rb.mu);
  while (rb.count == 0 && !rb.eof) {
    pthread_cond_wait(&rb.can_get, &rb.mu);
  }
  if (rb.count == 0) {  // eof and drained
    pthread_mutex_unlock(&rb.mu);
    return 0;
  }
  memcpy(out, rb.data.data() + static_cast<size_t>(rb.tail) * rb.frame_bytes,
         rb.frame_bytes);
  rb.tail = (rb.tail + 1) % rb.capacity;
  rb.count--;
  pthread_cond_signal(&rb.can_put);
  pthread_mutex_unlock(&rb.mu);
  return 1;
}

// Number of frames currently buffered (for tests/diagnostics).
int fp_buffered(FramePipe* fp) {
  if (!fp) return 0;
  pthread_mutex_lock(&fp->ring.mu);
  int n = fp->ring.count;
  pthread_mutex_unlock(&fp->ring.mu);
  return n;
}

void fp_close(FramePipe* fp) {
  if (!fp) return;
  pthread_mutex_lock(&fp->ring.mu);
  fp->stop = true;  // under the ring mutex: the reader reads it there too
  pthread_cond_broadcast(&fp->ring.can_put);
  pthread_cond_broadcast(&fp->ring.can_get);
  pthread_mutex_unlock(&fp->ring.mu);
  if (fp->reader_started) pthread_join(fp->reader, nullptr);
  delete fp;
}

// Parse a saveMat-format text matrix (space-separated %lf rows,
// LKof.cpp:139-150). Writes at most n doubles into out but returns the
// TOTAL number of values present in the file — so a caller comparing the
// return against rows*cols catches oversized/wrong-shape files instead of
// accepting a silent truncation.
long gf_load(const char* path, double* out, long n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 0, SEEK_END) != 0) {  // non-seekable special file
    fclose(f);
    return -1;
  }
  long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  std::string buf(static_cast<size_t>(size), '\0');
  if (fread(buf.data(), 1, static_cast<size_t>(size), f) !=
      static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  const char* p = buf.c_str();
  char* end = nullptr;
  long i = 0;
  for (;;) {
    double v = strtod(p, &end);
    if (end == p) break;
    if (i < n) out[i] = v;
    ++i;
    p = end;
  }
  return i;
}

// Write a matrix in saveMat format: "%f" + single space, newline per row
// (exactly the reference's fprintf loop, LKof.cpp:142-148).
int gf_save(const char* path, const double* data, long rows, long cols) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  for (long r = 0; r < rows; ++r) {
    for (long c = 0; c < cols; ++c) {
      fprintf(f, c + 1 < cols ? "%f " : "%f", data[r * cols + c]);
    }
    fputc('\n', f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
