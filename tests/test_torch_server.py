"""The port's HTTP server (serving/server.py) and its image codec, on the
CPU: the HTTP contract of the JAX package's tests/test_server.py against the
port's ``make_handler`` with the same stub predictors, the same bytes posted
to both packages' servers with real float32 predictors, the zlib codec
against cv2, and two clients posting at once. The zlib codec is for hosts
without OpenCV, so its tests run without cv2 too: only the comparisons with
cv2 itself (and with the JAX package's server, which needs it) skip there.
"""

import base64
import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

try:
    import cv2
except ImportError:  # the zlib codec's tests below still run
    cv2 = None
needs_cv2 = pytest.mark.skipif(cv2 is None, reason="compares with cv2, which is not installed")

from mtg_card_image_segmentation_tpu.serving import server as jax_server  # noqa: E402
from mtg_card_image_segmentation_tpu.serving.pose_predictor import (  # noqa: E402
    PosePredictor as JaxPosePredictor,
)
from mtg_card_image_segmentation_tpu.serving.predictor import (  # noqa: E402
    SegPredictor as JaxSegPredictor,
)

from mtg_card_image_segmentation_tpu_torch.serving import imagecodec  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import (  # noqa: E402
    PosePredictor,
)
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.serving.server import (  # noqa: E402
    DemoServer,
    InferenceThread,
    OnInferenceThread,
    make_handler,
)
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.utils.params import (  # noqa: E402
    init_flax_like,
    init_hrnet_flax_like,
)

torch.set_num_threads(2)

SEG_HW, POSE_HW, POSE_HM = (64, 48), (64, 96), (16, 24)


class _StubSeg:
    def predict(self, imgs):
        b, h, w, _ = imgs.shape
        m = np.zeros((b, h, w), np.uint8)
        m[:, : h // 2] = 1
        return m


class _StubPose:
    height, width = 64, 96

    def predict_valid(self, imgs):
        b = imgs.shape[0]
        px = np.tile(np.asarray([[10.0, 20.0], [30.0, 20.0],
                                 [30.0, 40.0], [10.0, 40.0]], np.float32),
                     (b, 1, 1))
        conf = np.full((b, 4), 0.9, np.float32)
        return px, conf, conf >= 0.3

    def scale_to_original(self, px, original_hw):
        oh, ow = original_hw
        return px * np.asarray(
            [(ow - 1) / (self.width - 1), (oh - 1) / (self.height - 1)],
            np.float32,
        )


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module", params=[pytest.param("cv2", marks=needs_cv2), "zlib"])
def server(request, tmp_path_factory):
    """The port's handler with the reference test's stubs, once per codec."""
    demo_dir = tmp_path_factory.mktemp("demo")
    models_dir = tmp_path_factory.mktemp("models")
    (demo_dir / "index.html").write_text("<html>demo</html>")
    (demo_dir / "secret_sibling").mkdir()
    codec = imagecodec.Cv2Codec() if request.param == "cv2" else imagecodec.ZlibCodec()
    httpd = _serve(make_handler(str(demo_dir), str(models_dir), _StubSeg(), (32, 24),
                                _StubPose(), (64, 96), codec))
    yield httpd.server_address[1], request.param
    httpd.shutdown()
    httpd.server_close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _image(h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _png_bytes(h=48, w=64, seed=0):
    return imagecodec.encode_png(_image(h, w, seed))


def _jpg_bytes(h=48, w=64):
    if cv2 is None:  # a JFIF header: enough for the zlib codec to name the format
        return b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(32)
    ok, buf = cv2.imencode(".jpg", _image(h, w))
    assert ok
    return buf.tobytes()


def _decode_mask(body):
    png = base64.b64decode(body["mask_png_b64"])
    if cv2 is None:
        return imagecodec.decode_png(png)[:, :, 0]
    return cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_GRAYSCALE)


# --------------------------------------------------------------------------
# the reference's HTTP contract (tests/test_server.py), both codecs
# --------------------------------------------------------------------------


def test_static_and_healthz(server):
    port, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/")
    assert conn.getresponse().read() == b"<html>demo</html>"
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200
    info = json.loads(resp.read())
    assert info["status"] == "ok" and info["tpu_inference"] is True
    assert info["model_hw"] == [32, 24] and info["models"] == []
    # path containment: no escaping the demo root
    conn.request("GET", "/../secret_sibling/")
    assert conn.getresponse().status in (400, 403, 404)
    conn.request("HEAD", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200 and resp.read() == b""
    conn.close()


def test_api_segment(server):
    port, codec = server
    status, data = _post(port, "/api/segment", _png_bytes() if codec == "zlib" else _jpg_bytes())
    assert status == 200, data
    body = json.loads(data)
    assert body["shape"] == [32, 24]
    assert body["card_fraction"] == 0.5
    assert body["inference_ms"] >= 0
    mask = _decode_mask(body)
    assert mask.shape == (32, 24)
    assert (mask[:16] == 255).all() and (mask[16:] == 0).all()


def test_api_corners(server):
    port, codec = server
    payload = _png_bytes(48, 64) if codec == "zlib" else _jpg_bytes(48, 64)
    status, data = _post(port, "/api/corners", payload)
    assert status == 200, data
    body = json.loads(data)
    assert len(body["corners"]) == 4
    assert body["valid"] == [True] * 4
    assert body["image_shape"] == [48, 64]
    # scale-to-original: model coords were for (64, 96)
    assert abs(body["corners"][0][0] - 10 * 63 / 95) < 0.05
    assert abs(body["corners"][0][1] - 20 * 47 / 63) < 0.05


@pytest.mark.parametrize("path", ["/api/corners", "/api/segment"])
def test_api_bad_image(server, path):
    port, _ = server
    status, data = _post(port, path, b"not an image")
    assert status == 400
    assert "error" in json.loads(data)


def test_jpeg_without_cv2_says_so(server):
    port, codec = server
    status, data = _post(port, "/api/segment", _jpg_bytes())
    if codec == "cv2":
        assert status == 200
    else:
        assert status == 400 and "cv2" in json.loads(data)["error"]


def test_unknown_route_and_missing_predictors(tmp_path):
    httpd = _serve(make_handler(str(tmp_path), str(tmp_path)))
    try:
        port = httpd.server_address[1]
        assert _post(port, "/api/segment", b"x")[0] == 503
        assert _post(port, "/api/corners", b"x")[0] == 503
        assert _post(port, "/api/nothing", b"x")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


# --------------------------------------------------------------------------
# the zlib codec against cv2
# --------------------------------------------------------------------------


@needs_cv2
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_matches_cv2(channels):
    """PNGs written by cv2 (which picks its own filters per row) decode to
    the same pixels (exact); grey is replicated and alpha dropped, as
    cv2.IMREAD_COLOR does."""
    rng = np.random.default_rng(channels)
    # smooth + noisy parts, so that the encoder uses several filter types
    base = np.linspace(0, 255, 40 * 52).reshape(40, 52, 1) + rng.normal(0, 6, (40, 52, channels))
    img = np.clip(base, 0, 255).astype(np.uint8)
    img = img[:, :, 0] if channels == 1 else img
    ok, buf = cv2.imencode(".png", img)
    assert ok
    data = buf.tobytes()
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    # cv2 wrote BGR(A): the file's own channel order is what decode_png gives
    got = imagecodec.ZlibCodec().decode(data)
    np.testing.assert_array_equal(got, want)
    raw = imagecodec.decode_png(data)
    assert raw.shape == (40, 52, channels)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_every_filter_type_round_trips(kind):
    """A PNG whose rows all use one filter type, built by hand with the
    filter's forward form, decodes to the source (exact) here and, where it
    is installed, in cv2."""
    import struct
    import zlib

    rng = np.random.default_rng(20 + kind)
    img = rng.integers(0, 256, (9, 7, 3), np.uint8)
    bpp, stride = 3, 21
    rows = img.reshape(9, stride).astype(np.int32)
    out = bytearray()
    for y in range(9):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros(stride, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            pred = np.zeros(stride, np.int32)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", 7, 9, 8, 2, 0, 0, 0)
    data = (imagecodec.PNG_SIGNATURE + imagecodec._chunk(b"IHDR", ihdr)
            + imagecodec._chunk(b"IDAT", zlib.compress(bytes(out))) + imagecodec._chunk(b"IEND", b""))
    np.testing.assert_array_equal(imagecodec.decode_png(data), img)
    if cv2 is None:
        return
    via_cv2 = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(via_cv2, img)


def test_png_encode_is_read_by_cv2_and_bad_files_raise():
    grey = (np.arange(30 * 20).reshape(30, 20) % 2 * 255).astype(np.uint8)
    np.testing.assert_array_equal(_decode_mask(
        {"mask_png_b64": base64.b64encode(imagecodec.encode_png(grey))}), grey)
    rgb = _image(11, 13, 5)
    np.testing.assert_array_equal(imagecodec.decode_png(imagecodec.encode_png(rgb)), rgb)
    good = imagecodec.encode_png(rgb)
    for bad in (b"", b"not an image", good[:40], imagecodec.PNG_SIGNATURE + b"\0" * 30):
        with pytest.raises(ValueError):
            imagecodec.ZlibCodec().decode(bad)
    import struct

    sixteen = good.replace(struct.pack(">IIB", 13, 11, 8), struct.pack(">IIB", 13, 11, 16), 1)
    with pytest.raises(ValueError, match="unsupported PNG"):  # 16 bits per sample
        imagecodec.decode_png(sixteen)


RESIZES = [((48, 64), (32, 24)), ((50, 37), (64, 96)), ((32, 24), (32, 24))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_is_half_pixel_bilinear(src, dst):
    """The zlib codec's resize against the half-pixel bilinear formula written
    out in numpy float64 (sample at ``(i + 0.5) * in / out - 0.5``, clamped to
    the edge), rounded to uint8: at most one grey level apart (float32 against
    float64 at a rounding tie)."""
    img = _image(*src, seed=9)
    ours = imagecodec.ZlibCodec().resize(img, *dst)

    def axis(n_in, n_out):
        pos = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
        lo = np.floor(pos).astype(int)
        return lo, np.minimum(lo + 1, n_in - 1), pos - lo

    (y0, y1, fy), (x0, x1, fx) = axis(src[0], dst[0]), axis(src[1], dst[1])
    a = img.astype(np.float64)
    rows = a[y0] * (1 - fy)[:, None, None] + a[y1] * fy[:, None, None]
    want = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    assert ours.dtype == np.uint8 and ours.shape == (*dst, 3)
    assert np.abs(ours.astype(np.int32) - np.rint(want).astype(np.int32)).max() <= 1


@needs_cv2
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_within_one_grey_level_of_cv2(src, dst):
    """The port's half-pixel bilinear, rounded to uint8, against
    cv2.resize(INTER_LINEAR): the same sample positions; cv2 computes with
    11-bit fixed-point weights, so a value may round one grey level apart."""
    img = _image(*src, seed=9)
    ours = imagecodec.ZlibCodec().resize(img, *dst)
    theirs = imagecodec.Cv2Codec().resize(img, *dst)
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape == (*dst, 3)
    assert np.abs(ours.astype(np.int32) - theirs.astype(np.int32)).max() <= 1


# --------------------------------------------------------------------------
# real predictors: both packages' servers on the same bytes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    seg, pose = init_flax_like(0), init_hrnet_flax_like(0)
    ckpt.save_params(str(root), "seg", *seg)
    ckpt.save_params(str(root), "pose", *pose)
    return root, seg, pose


@pytest.fixture(scope="module")
def port_server(checkpoints, tmp_path_factory):
    """The port's handler with float32 CPU predictors loaded from
    checkpoints (DemoServer itself builds bf16 predictors for the card)."""
    root, _, _ = checkpoints
    seg = SegPredictor.from_checkpoint(str(root), "seg", *SEG_HW, dtype=torch.float32,
                                       device="cpu")
    pose = PosePredictor.from_checkpoint(str(root), "pose", *POSE_HW, heatmap_hw=POSE_HM,
                                         dtype=torch.float32, device="cpu")
    d = tmp_path_factory.mktemp("static")
    httpd = _serve(make_handler(str(d), str(d), seg, SEG_HW, pose, POSE_HW))
    yield httpd.server_address[1], seg, pose
    httpd.shutdown()
    httpd.server_close()


@needs_cv2
def test_same_bytes_to_both_servers(checkpoints, port_server, tmp_path):
    """One PNG (of another size than either model's) posted to the JAX
    package's server and to the port's, both with float32 predictors on the
    same weights: equal ``shape`` and ``image_shape``, masks agreeing on
    >= 0.999 of the pixels (the deployment gate) and so ``card_fraction``
    within 1e-3, corners within 0.02 px (the JSON rounds to 0.01; the
    predictors agree to 1e-2, tests/test_torch_pose.py) and equal ``valid``."""
    _, (sp, ss), (pp, ps) = checkpoints
    port, _, _ = port_server
    jseg = JaxSegPredictor(jax.tree.map(jnp.asarray, sp), jax.tree.map(jnp.asarray, ss),
                           *SEG_HW, use_pallas=False, dtype=jnp.float32, auto_layout=False)
    jpose = JaxPosePredictor(jax.tree.map(jnp.asarray, pp), jax.tree.map(jnp.asarray, ps),
                             *POSE_HW, heatmap_hw=POSE_HM, dtype=jnp.float32,
                             use_pallas=False, auto_layout=False)
    httpd = _serve(jax_server.make_handler(str(tmp_path), str(tmp_path), jseg, SEG_HW,
                                           jpose, POSE_HW))
    try:
        jport = httpd.server_address[1]
        body = _png_bytes(80, 100, seed=3)
        (s1, d1), (s2, d2) = _post(jport, "/api/segment", body), _post(port, "/api/segment", body)
        assert s1 == s2 == 200, (d1, d2)
        a, b = json.loads(d1), json.loads(d2)
        assert set(a) == set(b)
        assert a["shape"] == b["shape"] == list(SEG_HW)
        assert (_decode_mask(a) == _decode_mask(b)).mean() >= 0.999
        assert abs(a["card_fraction"] - b["card_fraction"]) <= 1e-3
        (s1, d1), (s2, d2) = _post(jport, "/api/corners", body), _post(port, "/api/corners", body)
        assert s1 == s2 == 200, (d1, d2)
        a, b = json.loads(d1), json.loads(d2)
        assert set(a) == set(b)
        assert a["image_shape"] == b["image_shape"] == [80, 100]
        np.testing.assert_allclose(b["corners"], a["corners"], rtol=0, atol=0.02)
        np.testing.assert_allclose(b["confidences"], a["confidences"], rtol=0, atol=2e-4)
        assert a["valid"] == b["valid"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_http_answers_equal_direct_predict(port_server):
    """Over HTTP the mask equals ``predict`` on the same resized image and
    the corners ``predict_valid`` + ``scale_to_original`` (to the JSON's two
    decimals)."""
    port, seg, pose = port_server
    img = _image(80, 100, seed=4)
    codec = imagecodec.default_codec()
    status, data = _post(port, "/api/segment", imagecodec.encode_png(img))
    assert status == 200, data
    want = seg.predict(codec.resize(img, *SEG_HW)[None])[0].numpy()
    np.testing.assert_array_equal(_decode_mask(json.loads(data)), want * 255)
    status, data = _post(port, "/api/corners", imagecodec.encode_png(img))
    assert status == 200, data
    px, conf, valid = pose.predict_valid(codec.resize(img, *POSE_HW)[None])
    want_px = pose.scale_to_original(px[0].numpy(), (80, 100))
    body = json.loads(data)
    np.testing.assert_allclose(body["corners"], want_px, rtol=0, atol=0.006)
    assert body["valid"] == [bool(v) for v in valid[0]]


def test_two_threads_post_at_once(port_server):
    """Two clients posting segment and corners requests at the same time get
    the answers that serial requests get."""
    port, _, _ = port_server
    bodies = [_png_bytes(70 + i, 90, seed=10 + i) for i in range(4)]

    def ask(path, body):
        status, data = _post(port, path, body)
        assert status == 200, data
        out = json.loads(data)
        out.pop("inference_ms")
        return out

    serial = {(p, i): ask(p, b) for p in ("/api/segment", "/api/corners")
              for i, b in enumerate(bodies)}
    got, errors = {}, []

    def client(path):
        try:
            for i, b in enumerate(bodies):
                got[(path, i)] = ask(path, b)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(p,))
               for p in ("/api/segment", "/api/corners")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == serial


def test_demo_server_starts_from_checkpoints(checkpoints, tmp_path):
    """DemoServer builds both predictors with from_checkpoint, warms them,
    and serves on a free port; an unknown pose family is refused at start."""
    root, _, _ = checkpoints
    srv = DemoServer(str(tmp_path), str(tmp_path), port=0, checkpoint=str(root / "seg"),
                     height=SEG_HW[0], width=SEG_HW[1],
                     pose_checkpoint=str(root / "pose"), pose_height=POSE_HW[0],
                     pose_width=POSE_HW[1], host="127.0.0.1", device="cpu")
    srv.start_background()
    try:
        assert srv.port > 0 and srv.warm_seconds > 0
        status, data = _post(srv.port, "/api/segment", _png_bytes())
        assert status == 200 and json.loads(data)["shape"] == list(SEG_HW)
        status, data = _post(srv.port, "/api/corners", _png_bytes())
        assert status == 200 and len(json.loads(data)["corners"]) == 4
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="pose family"):
        DemoServer(str(tmp_path), str(tmp_path), port=0, pose_family="detr", device="cpu")
    with pytest.raises(FileNotFoundError):
        DemoServer(str(tmp_path), str(tmp_path), port=0, checkpoint=str(root / "missing"),
                   device="cpu")


def test_demo_server_freezes_the_heap_while_it_serves(checkpoints, tmp_path):
    """After warm-up the server collects once and freezes what the process
    holds, so that a full collection while serving scans only newer
    objects; ``shutdown`` unfreezes, and a stopped server's predictor can
    then be collected (a frozen reference cycle would keep it for good)."""
    import gc
    import weakref

    root, _, _ = checkpoints
    gc.unfreeze()
    srv = DemoServer(str(tmp_path), str(tmp_path), port=0, checkpoint=str(root / "seg"),
                     height=SEG_HW[0], width=SEG_HW[1], host="127.0.0.1", device="cpu")
    srv.start_background()
    try:
        assert gc.get_freeze_count() > 0
        predictor = weakref.ref(srv.predictor)
    finally:
        srv.shutdown()
    assert gc.get_freeze_count() == 0
    del srv
    gc.collect()
    assert predictor() is None


def test_predictor_calls_run_on_one_inference_thread():
    """Calls from several request threads all run on the one inference
    thread, in turn (a stub that is not re-entrant sees no overlap), results
    and exceptions reach their callers, and ``close`` ends the thread."""
    seen, active, overlaps = [], [0], [0]

    class Stub(_StubPose):
        def predict(self, imgs):
            active[0] += 1
            overlaps[0] += active[0] > 1
            seen.append(threading.get_ident())
            if imgs.shape[0] == 3:
                active[0] -= 1
                raise ValueError("three")
            out = np.full((imgs.shape[0], 2, 2), imgs.shape[0], np.uint8)
            active[0] -= 1
            return torch.from_numpy(out)

        def predict_valid(self, imgs):
            seen.append(threading.get_ident())
            return tuple(torch.from_numpy(a) for a in super().predict_valid(imgs))

    thread = InferenceThread()
    served = OnInferenceThread(Stub(), thread)
    results, callers = {}, []

    def client(n):
        callers.append(threading.get_ident())
        for _ in range(20):
            out = served.predict(np.zeros((n, 4, 4, 3), np.uint8))
            assert isinstance(out, np.ndarray) and out.shape == (n, 2, 2) and (out == n).all()
        results[n] = True

    threads = [threading.Thread(target=client, args=(n,)) for n in (1, 2, 4, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(results) == 4
    px, conf, valid = served.predict_valid(np.zeros((1, 4, 4, 3), np.uint8))
    assert all(isinstance(a, np.ndarray) for a in (px, conf, valid))
    with pytest.raises(ValueError, match="three"):
        served.predict(np.zeros((3, 4, 4, 3), np.uint8))
    assert served.predict(np.zeros((1, 4, 4, 3), np.uint8)).shape == (1, 2, 2)  # still serving
    assert len(set(seen)) == 1 and seen[0] not in callers and overlaps[0] == 0
    np.testing.assert_allclose(served.scale_to_original(px[0], (64, 96)), px[0])
    thread.close()
    assert not thread._thread.is_alive()


def test_server_needs_the_card_unless_asked(checkpoints, tmp_path, monkeypatch):
    """With no ``device`` the server's predictors go to the CUDA card, and
    without one the server refuses to start instead of serving from the
    host."""
    root, _, _ = checkpoints
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DemoServer(str(tmp_path), str(tmp_path), port=0, checkpoint=str(root / "seg"),
                   height=SEG_HW[0], width=SEG_HW[1], host="127.0.0.1")
    with pytest.raises(RuntimeError, match="CUDA"):
        DemoServer(str(tmp_path), str(tmp_path), port=0, pose_checkpoint=str(root / "pose"),
                   host="127.0.0.1")
