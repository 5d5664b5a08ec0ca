// Real V4L2 capture backend — direct ioctls, mmap ring, blocking DQBUF.
//
// accelerator-native port of the reference's flagship zero-copy driver
// (rustcv-camera/src/backend/linux/mod.rs:38-446 + sys.rs:18-443):
//   open(O_RDWR, blocking) → QUERYCAP → [enumerate fmt×size for the Python
//   negotiator] → S_FMT → S_PARM fps → disable exposure-auto-priority (the
//   low-light firmware-throttle fix, mod.rs:141-148) → REQBUFS/QUERYBUF/mmap
//   → QBUF all → STREAMON; hot path = ONE blocking DQBUF syscall per frame
//   (no poll/select — mod.rs:12-13), returning a zero-copy slice of
//   bytesused; the previous buffer is re-queued on the next dequeue.
//
// Negotiation scoring stays in Python (capture/negotiate.py ports the
// reference's formulas); this layer only enumerates and applies.

#include <cstdint>
#include <cstring>

#ifdef __linux__

#include <errno.h>
#include <fcntl.h>
#include <linux/videodev2.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr int kMaxBufs = 16;

struct V4l2Cam {
  int fd = -1;
  int nbufs = 0;
  void* maps[kMaxBufs] = {};
  size_t lengths[kMaxBufs] = {};
  int pending = -1;  // buffer owned by the consumer, re-QBUF on next dequeue
  bool streaming = false;
  uint32_t fourcc = 0;
  int width = 0, height = 0, stride = 0;
};

int xioctl(int fd, unsigned long req, void* arg) {
  int r;
  do {
    r = ioctl(fd, req, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}

}  // namespace

extern "C" {

int rcv_v4l2_available() { return 1; }

// Open + QUERYCAP. Returns a handle or null (errno-style code in *err).
void* rcv_v4l2_open(const char* path, int* err) {
  int fd = open(path, O_RDWR);  // intentionally blocking: DQBUF waits
  if (fd < 0) {
    *err = -errno;
    return nullptr;
  }
  v4l2_capability cap;
  memset(&cap, 0, sizeof(cap));
  if (xioctl(fd, VIDIOC_QUERYCAP, &cap) < 0) {
    *err = -errno;
    close(fd);
    return nullptr;
  }
  if (!(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
      !(cap.capabilities & V4L2_CAP_STREAMING)) {
    *err = -1000;  // not a streaming capture device
    close(fd);
    return nullptr;
  }
  V4l2Cam* c = new V4l2Cam();
  c->fd = fd;
  *err = 0;
  return c;
}

// Enumerate up to `cap` (fourcc, width, height, fps_num) modes. fps is the
// highest discrete rate advertised for that fmt×size (0 when unreported).
long rcv_v4l2_enum_modes(void* h, uint32_t* fourccs, int* widths,
                         int* heights, int* fps, long cap) {
  V4l2Cam* c = (V4l2Cam*)h;
  long n = 0;
  v4l2_fmtdesc fd;
  memset(&fd, 0, sizeof(fd));
  fd.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  for (fd.index = 0; xioctl(c->fd, VIDIOC_ENUM_FMT, &fd) == 0; fd.index++) {
    v4l2_frmsizeenum fs;
    memset(&fs, 0, sizeof(fs));
    fs.pixel_format = fd.pixelformat;
    for (fs.index = 0; xioctl(c->fd, VIDIOC_ENUM_FRAMESIZES, &fs) == 0;
         fs.index++) {
      if (fs.type != V4L2_FRMSIZE_TYPE_DISCRETE) break;
      if (n >= cap) return n;
      int best_fps = 0;
      v4l2_frmivalenum fi;
      memset(&fi, 0, sizeof(fi));
      fi.pixel_format = fd.pixelformat;
      fi.width = fs.discrete.width;
      fi.height = fs.discrete.height;
      for (fi.index = 0; xioctl(c->fd, VIDIOC_ENUM_FRAMEINTERVALS, &fi) == 0;
           fi.index++) {
        if (fi.type != V4L2_FRMIVAL_TYPE_DISCRETE) break;
        if (fi.discrete.numerator > 0) {
          int f = (int)(fi.discrete.denominator / fi.discrete.numerator);
          if (f > best_fps) best_fps = f;
        }
      }
      fourccs[n] = fd.pixelformat;
      widths[n] = (int)fs.discrete.width;
      heights[n] = (int)fs.discrete.height;
      fps[n] = best_fps;
      n++;
    }
  }
  return n;
}

// S_FMT + S_PARM + control fixes + REQBUFS/mmap + QBUF all + STREAMON.
// Fills the actually-applied geometry (drivers may adjust).
int rcv_v4l2_setup(void* h, uint32_t fourcc, int width, int height, int fps,
                   int nbufs, uint32_t* got_fourcc, int* got_w, int* got_h,
                   int* got_stride, long* got_sizeimage) {
  V4l2Cam* c = (V4l2Cam*)h;
  v4l2_format fmt;
  memset(&fmt, 0, sizeof(fmt));
  fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  fmt.fmt.pix.width = width;
  fmt.fmt.pix.height = height;
  fmt.fmt.pix.pixelformat = fourcc;
  fmt.fmt.pix.field = V4L2_FIELD_NONE;
  if (xioctl(c->fd, VIDIOC_S_FMT, &fmt) < 0) return -errno;
  c->fourcc = fmt.fmt.pix.pixelformat;
  c->width = (int)fmt.fmt.pix.width;
  c->height = (int)fmt.fmt.pix.height;
  c->stride = (int)fmt.fmt.pix.bytesperline;

  if (fps > 0) {
    v4l2_streamparm parm;
    memset(&parm, 0, sizeof(parm));
    parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    parm.parm.capture.timeperframe.numerator = 1;
    parm.parm.capture.timeperframe.denominator = (uint32_t)fps;
    xioctl(c->fd, VIDIOC_S_PARM, &parm);  // best-effort (mod.rs:133-139)
  }

  // Low-light firmware-throttle fix: without this, laptop UVC cameras drop
  // 30 fps → 10 fps in dim rooms (mod.rs:16-18,141-148; ctrl id sys.rs:443).
  v4l2_control ctrl;
  memset(&ctrl, 0, sizeof(ctrl));
  ctrl.id = 0x009a0903;  // V4L2_CID_EXPOSURE_AUTO_PRIORITY
  ctrl.value = 0;
  xioctl(c->fd, VIDIOC_S_CTRL, &ctrl);  // best-effort

  if (nbufs < 2) nbufs = 2;
  if (nbufs > kMaxBufs) nbufs = kMaxBufs;
  v4l2_requestbuffers req;
  memset(&req, 0, sizeof(req));
  req.count = (uint32_t)nbufs;
  req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  req.memory = V4L2_MEMORY_MMAP;
  if (xioctl(c->fd, VIDIOC_REQBUFS, &req) < 0) return -errno;
  if (req.count < 2) return -1001;  // insufficient buffer memory
  c->nbufs = (int)req.count;

  for (int i = 0; i < c->nbufs; ++i) {
    v4l2_buffer buf;
    memset(&buf, 0, sizeof(buf));
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = (uint32_t)i;
    if (xioctl(c->fd, VIDIOC_QUERYBUF, &buf) < 0) return -errno;
    c->lengths[i] = buf.length;
    c->maps[i] = mmap(nullptr, buf.length, PROT_READ | PROT_WRITE,
                      MAP_SHARED, c->fd, buf.m.offset);
    if (c->maps[i] == MAP_FAILED) {
      c->maps[i] = nullptr;
      return -errno;
    }
  }
  for (int i = 0; i < c->nbufs; ++i) {
    v4l2_buffer buf;
    memset(&buf, 0, sizeof(buf));
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = (uint32_t)i;
    if (xioctl(c->fd, VIDIOC_QBUF, &buf) < 0) return -errno;
  }
  v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(c->fd, VIDIOC_STREAMON, &type) < 0) return -errno;
  c->streaming = true;

  *got_fourcc = c->fourcc;
  *got_w = c->width;
  *got_h = c->height;
  *got_stride = c->stride;
  *got_sizeimage = (long)fmt.fmt.pix.sizeimage;
  return 0;
}

// Hot path (mod.rs:194-237): re-QBUF the consumer's previous buffer, then
// one blocking DQBUF. Returns the buffer index (consumer owns it until the
// next call) with a zero-copy pointer to exactly `bytesused` bytes.
long rcv_v4l2_dequeue(void* h, uint8_t** data, long* bytesused, long* seq,
                      long* ts_ns) {
  V4l2Cam* c = (V4l2Cam*)h;
  if (!c->streaming) return -2000;
  if (c->pending >= 0) {
    v4l2_buffer buf;
    memset(&buf, 0, sizeof(buf));
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = (uint32_t)c->pending;
    if (xioctl(c->fd, VIDIOC_QBUF, &buf) < 0) return -errno;
    c->pending = -1;
  }
  v4l2_buffer buf;
  memset(&buf, 0, sizeof(buf));
  buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  buf.memory = V4L2_MEMORY_MMAP;
  if (xioctl(c->fd, VIDIOC_DQBUF, &buf) < 0) return -errno;  // blocks here
  c->pending = (int)buf.index;
  *data = (uint8_t*)c->maps[buf.index];
  *bytesused = (long)buf.bytesused;
  *seq = (long)buf.sequence;
  *ts_ns = (long)buf.timestamp.tv_sec * 1000000000L +
           (long)buf.timestamp.tv_usec * 1000L;
  return buf.index;
}

// Generic control plane (VIDIOC_S_CTRL/G_CTRL) — the Python layer maps the
// reference's CID set (exposure/gain/zoom/focus, controls.rs:15-26).
int rcv_v4l2_set_ctrl(void* h, uint32_t id, int32_t value) {
  V4l2Cam* c = (V4l2Cam*)h;
  v4l2_control ctrl;
  memset(&ctrl, 0, sizeof(ctrl));
  ctrl.id = id;
  ctrl.value = value;
  return xioctl(c->fd, VIDIOC_S_CTRL, &ctrl) < 0 ? -errno : 0;
}

int rcv_v4l2_get_ctrl(void* h, uint32_t id, int32_t* value) {
  V4l2Cam* c = (V4l2Cam*)h;
  v4l2_control ctrl;
  memset(&ctrl, 0, sizeof(ctrl));
  ctrl.id = id;
  if (xioctl(c->fd, VIDIOC_G_CTRL, &ctrl) < 0) return -errno;
  *value = ctrl.value;
  return 0;
}

int rcv_v4l2_stop(void* h) {
  V4l2Cam* c = (V4l2Cam*)h;
  if (c->streaming) {
    v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    xioctl(c->fd, VIDIOC_STREAMOFF, &type);
    c->streaming = false;
    c->pending = -1;
  }
  return 0;
}

// Resume after rcv_v4l2_stop: STREAMOFF returned all buffers to userspace,
// so re-queue the whole ring and STREAMON again.
int rcv_v4l2_restart(void* h) {
  V4l2Cam* c = (V4l2Cam*)h;
  if (c->streaming) return 0;
  if (c->nbufs == 0) return -2001;  // setup never ran
  for (int i = 0; i < c->nbufs; ++i) {
    v4l2_buffer buf;
    memset(&buf, 0, sizeof(buf));
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = (uint32_t)i;
    if (xioctl(c->fd, VIDIOC_QBUF, &buf) < 0) return -errno;
  }
  v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(c->fd, VIDIOC_STREAMON, &type) < 0) return -errno;
  c->streaming = true;
  c->pending = -1;
  return 0;
}

void rcv_v4l2_close(void* h) {
  V4l2Cam* c = (V4l2Cam*)h;
  rcv_v4l2_stop(h);
  for (int i = 0; i < c->nbufs; ++i) {
    if (c->maps[i]) munmap(c->maps[i], c->lengths[i]);  // Drop → munmap
  }
  if (c->fd >= 0) close(c->fd);
  delete c;
}

}  // extern "C"

#else  // !__linux__

extern "C" {
int rcv_v4l2_available() { return 0; }
void* rcv_v4l2_open(const char*, int* err) {
  *err = -1;
  return nullptr;
}
long rcv_v4l2_enum_modes(void*, uint32_t*, int*, int*, int*, long) { return -1; }
int rcv_v4l2_setup(void*, uint32_t, int, int, int, int, uint32_t*, int*, int*,
                   int*, long*) {
  return -1;
}
long rcv_v4l2_dequeue(void*, uint8_t**, long*, long*, long*) { return -1; }
int rcv_v4l2_set_ctrl(void*, uint32_t, int32_t) { return -1; }
int rcv_v4l2_get_ctrl(void*, uint32_t, int32_t*) { return -1; }
int rcv_v4l2_restart(void*) { return -1; }
int rcv_v4l2_stop(void*) { return -1; }
void rcv_v4l2_close(void*) {}
}

#endif
