"""MJPEG-over-HTTP streaming — port of
``rustcv-backend-v4l2/examples/web_streaming.rs:44-100`` (and the dual-camera
variant): a capture task feeds frames through the device pipeline, JPEG-encodes
on the host, and broadcasts the bytes to any number of connected HTTP
clients as a ``multipart/x-mixed-replace`` stream.

Run, then open http://localhost:8080/ (or /stream/0, /stream/1 for specific
cameras). Pure stdlib HTTP; the broadcast channel is a Condition-guarded
latest-frame slot per stream (the tokio::sync::broadcast analog).
"""

import argparse
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from rustcv_tpu.capture import SimulationDriver
from rustcv_tpu.core import PixelFormat, SimpleConfig
from rustcv_tpu.runtime import MultiStreamEngine


class Broadcast:
    """Latest-frame broadcast: writers publish, readers wait for a newer
    version (slow readers skip frames instead of back-pressuring capture)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._payload: bytes = b""
        self._version = 0

    def publish(self, payload: bytes) -> None:
        with self._cond:
            self._payload = payload
            self._version += 1
            self._cond.notify_all()

    def wait(self, last_version: int, timeout: float = 2.0):
        with self._cond:
            self._cond.wait_for(lambda: self._version > last_version, timeout)
            return self._payload, self._version


def capture_loop(engine: MultiStreamEngine, channels, stop: threading.Event,
                 quality: int, encoder: str = "tpu"):
    from PIL import Image

    if encoder == "tpu" and engine.spec.encode_jpeg:
        # The production hot path: the tick program emits block-packed
        # quantized coefficients; engine.stream_encoded pipelines device
        # compute, the (small) async D2H, and host Huffman coding across
        # ticks — the host link carries JPEG-sized payloads, never raw BGR.
        while not stop.is_set():
            try:
                for _res, payloads in engine.stream_encoded(stop=stop):
                    for ch, payload in zip(channels, payloads):
                        ch.publish(payload)
            except Exception as e:  # noqa: BLE001 — backoff (web_streaming.rs:95-99)
                print(f"capture error: {e}; backing off")
                stop.wait(0.5)
        return

    while not stop.is_set():
        try:
            res = engine.tick(block=True)
            if encoder == "tpu":
                # Unfused fallback: batch-encode the BGR output in a second
                # dispatch (engines built without encode_jpeg_quality).
                from rustcv_tpu.ops.jpeg_encode import encode_jpeg_batch_tpu

                dev = res.outputs["bgr"]
                if dev.ndim == 3:  # packed rows (N, H, W*3)
                    n, h, w3 = dev.shape
                    dev = dev.reshape(n, h, w3 // 3, 3)
                payloads = encode_jpeg_batch_tpu(dev, quality)
                for ch, payload in zip(channels, payloads):
                    ch.publish(payload)
                continue
            bgr = res.numpy("bgr")  # (N, H, W, 3)
            for i, ch in enumerate(channels):
                buf = io.BytesIO()
                Image.fromarray(bgr[i][..., ::-1]).save(buf, "JPEG", quality=quality)
                ch.publish(buf.getvalue())
        except Exception as e:  # noqa: BLE001 — backoff loop (web_streaming.rs:95-99)
            print(f"capture error: {e}; backing off")
            stop.wait(0.5)


def make_handler(channels):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path in ("/", "/stream"):
                idx = 0
            elif self.path.startswith("/stream/"):
                try:
                    idx = int(self.path.split("/")[-1])
                except ValueError:
                    self.send_error(404)
                    return
            else:
                self.send_error(404)
                return
            if not (0 <= idx < len(channels)):
                self.send_error(404)
                return
            ch = channels[idx]
            self.send_response(200)
            self.send_header(
                "Content-Type", "multipart/x-mixed-replace; boundary=frame"
            )
            self.end_headers()
            version = 0
            try:
                while True:
                    payload, version = ch.wait(version)
                    if not payload:
                        continue
                    self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n")
                    self.wfile.write(f"Content-Length: {len(payload)}\r\n\r\n".encode())
                    self.wfile.write(payload)
                    self.wfile.write(b"\r\n")
            except (BrokenPipeError, ConnectionResetError):
                return

    return Handler


def main(port: int = 8080, n_streams: int = 2, width: int = 640, height: int = 480,
         quality: int = 80, duration: float = 0.0, encoder: str = "tpu") -> None:
    engine = MultiStreamEngine(
        SimulationDriver(device_count=n_streams, paced=True), n_streams,
        SimpleConfig(width=width, height=height, fps=30, pixel_format=PixelFormat.YUYV),
        overlay=False, device_sim=True,
        # Fuse the JPEG encoder's numeric half into the tick program.
        encode_jpeg_quality=quality if encoder == "tpu" else 0,
    )
    channels = [Broadcast() for _ in range(n_streams)]
    stop = threading.Event()
    t = threading.Thread(target=capture_loop,
                         args=(engine, channels, stop, quality, encoder), daemon=True)
    t.start()

    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(channels))
    print(f"streaming {n_streams} cameras at http://localhost:{port}/stream/<i>")
    try:
        if duration > 0:
            threading.Timer(duration, server.shutdown).start()
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        engine.close()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--streams", type=int, default=2)
    p.add_argument("--duration", type=float, default=0.0, help="auto-stop after N s")
    p.add_argument("--encoder", choices=("host", "tpu"), default="tpu",
                   help="JPEG encoder: the hybrid device FDCT path (default) or host PIL")
    a = p.parse_args()
    main(a.port, a.streams, duration=a.duration, encoder=a.encoder)
