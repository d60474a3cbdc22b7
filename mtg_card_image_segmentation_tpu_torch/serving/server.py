"""HTTP serving on the card (counterpart of the JAX package's
``serving/server.py``: same routes, status codes, JSON keys and arguments).

    python -m mtg_card_image_segmentation_tpu_torch.serving.server \\
        --checkpoint <dir>/<name> [--height 320 --width 240] \\
        --pose-checkpoint <dir>/<name> [--pose-family hrnet|yolo]

    GET  /                      demo client (static)
    GET  /models/<file>         exported ONNX models (static)
    GET  /healthz               liveness + model info
    POST /api/segment           image bytes (png, jpg with cv2) -> JSON
                                {mask_png_b64, card_fraction, inference_ms,
                                shape} via SegPredictor
    POST /api/corners           image bytes -> JSON {corners (original image
                                pixels), confidences, valid, inference_ms,
                                image_shape} via PosePredictor or
                                YoloCornerPredictor

The predictors run on the CUDA card (``device=None``) through the
hand-written kernels; ``device="cpu"`` is for tests. ``inference_ms`` covers
the predictor call and the copy of its result to the host, which waits for
the device. Every request is answered on its own thread, but every predictor
call runs on ONE long-lived inference thread (:class:`InferenceThread`):
PyTorch keeps its cuDNN and cuBLAS handles per thread, and a thread that
calls a model for the first time pays for them, many times what a
single-image call itself costs (PERF.md has the readings), so a thread per
request must not touch the device. The predictors are built and warmed on that
thread (kernels built, per-shape tables filled, handles made) before the
socket is served. Then the objects the process holds are collected once and
frozen (``gc.freeze``), so that a full garbage collection while serving scans
only what was made since: otherwise one such collection in a process with a
large heap stalls every request in flight for hundreds of milliseconds
(PERF.md has the readings). ``shutdown`` unfreezes them. Checkpoints are the port's own
format (``training/checkpoint.py``).
"""

from __future__ import annotations

import base64
import concurrent.futures
import gc
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from mtg_card_image_segmentation_tpu_torch.serving.imagecodec import default_codec

_CONTENT_TYPES = {
    ".html": "text/html",
    ".js": "application/javascript",
    ".css": "text/css",
    ".json": "application/json",
    ".onnx": "application/octet-stream",
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".npz": "application/octet-stream",
    ".md": "text/markdown",
}
_MAX_BODY = 32 * 1024 * 1024


def _to_host(x) -> np.ndarray:
    """A predictor's result as a host array; for a device tensor this is the
    copy that waits for the result."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class InferenceThread:
    """One long-lived thread that runs every call handed to :meth:`call`, in
    order, and gives the caller the result or the exception."""

    def __init__(self) -> None:
        self._calls: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="inference")
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._calls.get()
            if item is None:
                return
            future, fn, args = item
            try:
                future.set_result(fn(*args))
            except Exception as e:  # noqa: BLE001 - handed to the caller
                future.set_exception(e)

    def call(self, fn, *args):
        future: "concurrent.futures.Future" = concurrent.futures.Future()
        self._calls.put((future, fn, args))
        return future.result()

    def close(self) -> None:
        self._calls.put(None)
        self._thread.join(timeout=60)


class OnInferenceThread:
    """A predictor's serving interface (``predict``, ``predict_valid``,
    ``scale_to_original``) with the device work, the copy of the results to
    the host included, done on an :class:`InferenceThread`."""

    def __init__(self, predictor, thread: InferenceThread) -> None:
        self._predictor, self._thread = predictor, thread

    def predict(self, images_u8):
        return self._thread.call(lambda: _to_host(self._predictor.predict(images_u8)))

    def predict_valid(self, images_u8):
        return self._thread.call(
            lambda: tuple(_to_host(a) for a in self._predictor.predict_valid(images_u8)))

    def scale_to_original(self, px, original_hw):
        return self._predictor.scale_to_original(px, original_hw)


def make_handler(demo_dir: str, models_dir: str, predictor=None, model_hw=None,
                 pose_predictor=None, pose_hw=None, codec=None):
    codec = codec or default_codec()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def _serve_static(self, root: str, rel: str):
            rel = rel.split("?", 1)[0].split("#", 1)[0]
            root_abs = os.path.abspath(root)
            path = os.path.normpath(os.path.join(root_abs, rel.lstrip("/")))
            # trailing-sep compare: a sibling dir whose name merely extends
            # the root (exported_models_old vs exported_models) must not pass
            if path != root_abs and not path.startswith(root_abs + os.sep):
                return self._send(403, b'{"error": "forbidden"}')
            if os.path.isdir(path):
                path = os.path.join(path, "index.html")
            if not os.path.isfile(path):
                return self._send(404, b'{"error": "not found"}')
            ext = os.path.splitext(path)[1].lower()
            with open(path, "rb") as f:
                self._send(200, f.read(), _CONTENT_TYPES.get(ext, "application/octet-stream"))

        def do_HEAD(self):
            # same routing as GET; _send suppresses the body for HEAD
            self.do_GET()

        def do_GET(self):
            if self.path.startswith("/healthz"):
                info = {
                    "status": "ok",
                    # the key the reference's clients read: "a device
                    # predictor is loaded"
                    "tpu_inference": predictor is not None,
                    "model_hw": model_hw,
                    "models": sorted(os.listdir(models_dir))
                    if os.path.isdir(models_dir)
                    else [],
                }
                return self._send(200, json.dumps(info).encode())
            if self.path.startswith("/models/"):
                return self._serve_static(models_dir, self.path[len("/models/"):])
            return self._serve_static(demo_dir, self.path)

        def _read_body(self):
            """The request body, or None after answering 400."""
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                self._send(400, b'{"error": "bad content length"}')
                return None
            return self.rfile.read(length)

        def do_POST(self):
            if self.path == "/api/corners":
                return self._post_corners()
            if self.path != "/api/segment":
                return self._send(404, b'{"error": "not found"}')
            if predictor is None:
                return self._send(
                    503, b'{"error": "predictor not loaded (start with --checkpoint)"}'
                )
            data = self._read_body()
            if data is None:
                return None
            try:
                h, w = model_hw
                img = codec.resize(codec.decode(data), h, w)
                t0 = time.perf_counter()
                mask = _to_host(predictor.predict(img[None]))[0]
                dt = (time.perf_counter() - t0) * 1e3
                png = codec.encode_png(mask * 255)
                body = json.dumps(
                    {
                        "mask_png_b64": base64.b64encode(png).decode(),
                        "card_fraction": float(mask.mean()),
                        "inference_ms": round(dt, 2),
                        "shape": [int(h), int(w)],
                    }
                ).encode()
                return self._send(200, body)
            except Exception as e:  # noqa: BLE001 - a bad request must not end the server
                return self._send(400, json.dumps({"error": str(e)}).encode())

        def _post_corners(self):
            """Corner detection: image bytes -> JSON {corners: [[x, y], ...]
            in ORIGINAL image pixels, confidences, valid, inference_ms,
            image_shape}."""
            if pose_predictor is None:
                return self._send(
                    503,
                    b'{"error": "pose predictor not loaded '
                    b'(start with --pose-checkpoint)"}',
                )
            data = self._read_body()
            if data is None:
                return None
            try:
                img = codec.decode(data)
                oh, ow = img.shape[:2]
                h, w = pose_hw
                img_r = codec.resize(img, h, w)
                t0 = time.perf_counter()
                px, conf, valid = (_to_host(a) for a in
                                   pose_predictor.predict_valid(img_r[None]))
                dt = (time.perf_counter() - t0) * 1e3
                # back to the original image; the predictor knows its own
                # coordinate convention (HRNet align-corners, YOLO half-pixel)
                px = pose_predictor.scale_to_original(px[0], (oh, ow))
                body = json.dumps(
                    {
                        "corners": [[round(float(x), 2), round(float(y), 2)]
                                    for x, y in px],
                        "confidences": [round(float(c), 4) for c in conf[0]],
                        "valid": [bool(v) for v in valid[0]],
                        "inference_ms": round(dt, 2),
                        "image_shape": [int(oh), int(ow)],
                    }
                ).encode()
                return self._send(200, body)
            except Exception as e:  # noqa: BLE001 - a bad request must not end the server
                return self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


class DemoServer:
    """The server with its predictors loaded from checkpoints and warmed.
    ``port=0`` takes a free port (``self.port`` says which); ``device=None``
    is the CUDA card and raises without one."""

    def __init__(
        self,
        demo_dir: str,
        models_dir: str,
        port: int = 5000,
        checkpoint: Optional[str] = None,
        height: int = 320,
        width: int = 240,
        pose_checkpoint: Optional[str] = None,
        pose_height: int = 480,
        pose_width: int = 640,
        pose_family: str = "hrnet",
        host: str = "0.0.0.0",
        device=None,
        codec=None,
    ) -> None:
        if pose_family not in ("hrnet", "yolo"):
            raise ValueError(f"unknown pose family {pose_family!r}")
        self.predictor = None
        if checkpoint:
            from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor

            ckpt_dir, name = os.path.split(os.path.normpath(checkpoint))
            self.predictor = SegPredictor.from_checkpoint(
                ckpt_dir or ".", name, height, width, device=device
            )
        self.pose_predictor = None
        if pose_checkpoint:
            ckpt_dir, name = os.path.split(os.path.normpath(pose_checkpoint))
            if pose_family == "yolo":
                from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (
                    YoloCornerPredictor,
                )

                # YOLO runs on square inputs (imgsz = the larger side)
                pose_height = pose_width = max(pose_height, pose_width)
                self.pose_predictor = YoloCornerPredictor.from_checkpoint(
                    ckpt_dir or ".", name, imgsz=pose_height, device=device
                )
            else:
                from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (
                    PosePredictor,
                )

                self.pose_predictor = PosePredictor.from_checkpoint(
                    ckpt_dir or ".", name, pose_height, pose_width, device=device
                )
        self.model_hw = (height, width)
        self.pose_hw = (pose_height, pose_width)
        self.codec = codec or default_codec()
        self.inference = InferenceThread()
        served = [p if p is None else OnInferenceThread(p, self.inference)
                  for p in (self.predictor, self.pose_predictor)]
        self.warm_seconds = self._warm(*served)
        gc.collect()
        gc.freeze()
        handler = make_handler(
            os.path.abspath(demo_dir), os.path.abspath(models_dir),
            served[0], self.model_hw, served[1], self.pose_hw, self.codec,
        )
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]

    def _warm(self, predictor, pose_predictor) -> float:
        """One call of each predictor on the inference thread before any
        request: builds and loads the kernels, fills the per-shape tables,
        makes the thread's library handles and picks the conv plans."""
        t0 = time.perf_counter()
        if predictor is not None:
            predictor.predict(np.zeros((1, *self.model_hw, 3), np.uint8))
        if pose_predictor is not None:
            pose_predictor.predict_valid(np.zeros((1, *self.pose_hw, 3), np.uint8))
        return time.perf_counter() - t0

    def serve_forever(self):
        print(f"serving demo on http://localhost:{self.port} "
              f"(/, /models, /healthz, POST /api/segment, POST /api/corners; "
              f"image codec: {self.codec.name})")
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.inference.close()
        gc.unfreeze()  # what the server held can be collected again


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--demo-dir", default="demo")
    parser.add_argument("--models-dir", default="exported_models")
    parser.add_argument("--checkpoint", default=None,
                        help="enable the /api/segment endpoint")
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=240)
    parser.add_argument("--pose-checkpoint", default=None,
                        help="enable the /api/corners endpoint")
    parser.add_argument("--pose-height", type=int, default=480)
    parser.add_argument("--pose-width", type=int, default=640)
    parser.add_argument("--pose-family", choices=["hrnet", "yolo"],
                        default="hrnet",
                        help="which corner model the checkpoint holds "
                             "(yolo uses square imgsz = max(h, w))")
    args = parser.parse_args()
    DemoServer(
        args.demo_dir, args.models_dir, args.port, args.checkpoint,
        args.height, args.width,
        args.pose_checkpoint, args.pose_height, args.pose_width,
        args.pose_family,
    ).serve_forever()


if __name__ == "__main__":
    main()
