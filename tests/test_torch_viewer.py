"""The port's viewer (`viewer/server.py`) on the CPU: the wire protocol
round trip and the in-train poll (as `tests/test_aux_utils.py` holds the
JAX package's), the received camera against the JAX server's on the same
bytes (1e-6), `serve_model` on port 0 answering two requests and a
keep-alive with frames equal to the uint8 quantisation of the port's own
`render()` of the same cameras, the train CLI's `--viewer_port` answering
a client while it trains, and `render(scaling_modifier=0.5)` against the
JAX package's Pallas path in interpret mode (images atol 1e-4, ED depth
rtol 2e-4, alphas atol 2e-5)."""
import socket
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from horizongs_tpu.render import render as j_render
from horizongs_tpu.train.optim import mlps_from_params
from horizongs_tpu.viewer.server import ViewerServer as JViewerServer
from horizongs_tpu_torch.cli.common import load_config
from horizongs_tpu_torch.convert import anchor_state_from_numpy, mlps_from_numpy
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.data.synthetic import orbit_cameras
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.render import render as t_render
from horizongs_tpu_torch.train import trainer as ttrainer_mod
from horizongs_tpu_torch.viewer.server import (
    ViewerServer,
    frame_message,
    parse_request,
    quantize,
    request_message,
    serve_model,
    wire_camera,
)
from test_torch_serve_cli import train_model, write_dataset

torch.set_num_threads(1)


def _message(W, H, view, train=False):
    return {"resolution_x": W, "resolution_y": H, "train": train,
            "fov_y": 0.8, "fov_x": 0.8, "z_near": 0.01, "z_far": 100.0,
            "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0,
            "view_matrix": list(view.flatten()),
            "view_projection_matrix": list(np.eye(4).flatten())}


def _read_frame(s, n_bytes):
    """One answer: n_bytes of image (0 for a keep-alive), then the
    verify string."""
    img = b""
    while len(img) < n_bytes:
        img += s.recv(n_bytes - len(img))
    n = int.from_bytes(s.recv(4), "little")
    return img, s.recv(n).decode()


def test_viewer_protocol_roundtrip():
    srv = ViewerServer(port=0)
    port = srv.bound_port
    W = H = 16
    result = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        view = np.eye(4)
        view[3, 2] = 4.0   # row-vector convention translation
        s.sendall(frame_message(_message(W, H, view)))
        img, result["verify"] = _read_frame(s, W * H * 3)
        result["img"] = np.frombuffer(img, np.uint8).reshape(H, W, 3)
        s.close()

    th = threading.Thread(target=client)
    th.start()
    got = {}
    for _ in range(2000):
        if srv.try_connect():
            got.update(srv.receive())
            srv.send_image(np.full((H, W, 3), 0.5), "model_x")
            break
    th.join(timeout=5)
    srv.close()
    assert result["verify"] == "model_x"
    assert (result["img"] == 127).all()
    assert got["width"] == W
    # y/z columns flipped, transposed: the translation lands in viewmat[:3, 3]
    assert abs(got["viewmat"][2, 3]) == pytest.approx(4.0)


def test_viewer_poll():
    """No client: the poll is a no-op; a client: one answer."""
    srv = ViewerServer(port=0)
    port = srv.bound_port
    srv.poll(lambda cam: np.zeros((4, 4, 3)), "m")
    W = H = 8
    result = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=5)
        s.sendall(frame_message(_message(W, H, np.eye(4), train=True)))
        _, result["verify"] = _read_frame(s, W * H * 3)
        s.close()

    th = threading.Thread(target=client)
    th.start()
    for _ in range(500):
        srv.poll(lambda cam: torch.ones((cam["height"], cam["width"], 3)),
                 "mp")
        if result.get("verify"):
            break
        time.sleep(0.01)
    th.join(timeout=5)
    srv.close()
    assert result["verify"] == "mp"


def _sent_bytes(srv, image, verify="v"):
    """The bytes `srv.send_image` puts on the wire for `image`."""
    a, b = socket.socketpair()
    srv.conn = a
    got = bytearray()

    def read():
        while chunk := b.recv(1 << 16):
            got.extend(chunk)
    reader = threading.Thread(target=read)
    reader.start()
    try:
        srv.send_image(image, verify)
    finally:
        srv.drop_client()
        reader.join(timeout=30)
        b.close()
    assert not reader.is_alive()
    return bytes(got)


def _host_images():
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.3, 1.3, (12, 20, 3))
    x[0, :4, 0] = [np.nan, np.inf, -np.inf, -0.0]
    rgbd = torch.from_numpy(rng.uniform(-0.3, 1.3, (12, 20, 4))
                            .astype(np.float32))
    return {"array_f64": x, "array_f32": x.astype(np.float32),
            "cpu_tensor": torch.from_numpy(x.astype(np.float32)),
            "cpu_tensor_rgb_of_rgbd": rgbd[..., :3],
            "array_transposed": np.ascontiguousarray(
                x.transpose(1, 0, 2)).transpose(1, 0, 2)}


@pytest.mark.parametrize("name", sorted(_host_images()))
def test_host_path_sends_numpy_bytes(name):
    """Arrays and CPU tensors keep the numpy quantize (clip, x 255, cast),
    and the frame's view on the wire is the bytes of `tobytes()`, in C
    order for a transposed array too."""
    from horizongs_tpu_torch.ops.quantize import KERNEL
    image = _host_images()[name]
    plain = np.asarray(image.numpy() if torch.is_tensor(image) else image)
    with np.errstate(invalid="ignore"):
        want = (np.clip(plain, 0.0, 1.0) * 255).astype(np.uint8)
        np.testing.assert_array_equal(quantize(image), want)
    srv = ViewerServer(port=0)
    before = KERNEL.launches
    try:
        with np.errstate(invalid="ignore"):
            got = _sent_bytes(srv, image, "model_x")
    finally:
        srv.close()
    assert got == want.tobytes() + (7).to_bytes(4, "little") + b"model_x"
    assert srv.quantize_on_card.buffers == {}
    assert KERNEL.launches == before


def test_quantize_counters_count_while_recording():
    """`viewer.frames_quantized` counts each image frame and
    `viewer.frames_on_card` those quantized on the card (none here) while
    a profiler records; nothing is counted otherwise. The benchmark's
    reader turns them into the share on the card."""
    from torch.profiler import ProfilerActivity, profile

    from hgsbench.run import reader
    from horizongs_tpu_torch import tracing
    image = np.full((4, 6, 3), 0.25)
    srv = ViewerServer(port=0)
    tracing.reset()
    try:
        _sent_bytes(srv, image)
        assert tracing.snapshot()["counters"] == {}
        with profile(activities=[ProfilerActivity.CPU]):
            _sent_bytes(srv, image)
            _sent_bytes(srv, None)
            _sent_bytes(srv, torch.from_numpy(image))
        snap = tracing.snapshot()
        _sent_bytes(srv, image)
        assert tracing.snapshot()["counters"] == snap["counters"]
    finally:
        tracing.reset()
        srv.close()
    assert snap["counters"] == {"viewer.frames_quantized": [1, 1]}
    run = SimpleNamespace(kind="view", program_spans=snap)
    assert reader("viewer.quantize_card_pct")(run) == 0.0
    run.program_spans = {"spans": [], "counters": {}}
    assert reader("viewer.quantize_card_pct")(run) is None


def test_card_quantize_imports_and_refuses_without_a_card():
    """The wrapper module imports and builds nothing without a card; it
    takes only an (H, W, 3) float32 CUDA tensor."""
    from horizongs_tpu_torch.ops import quantize as card
    q = card.FrameQuantizer()
    for bad in (torch.zeros(4, 6, 3), np.zeros((4, 6, 3), np.float32)):
        with pytest.raises(ValueError, match="float32 CUDA tensor"):
            q(bad)
    assert q.buffers == {} and card.KERNEL._fn is None


def test_receive_matches_jax():
    """The same request bytes into both servers: the same camera."""
    rng = np.random.default_rng(3)
    view = np.eye(4)
    view[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    view[3, :3] = rng.normal(size=3)
    msg = _message(40, 24, view)
    msg["scaling_modifier"] = 0.5
    got = {}
    for name, cls in (("jax", JViewerServer), ("torch", ViewerServer)):
        srv = cls(port=0)
        s = socket.create_connection(("127.0.0.1", srv.bound_port),
                                     timeout=5)
        s.sendall(frame_message(msg))
        while not srv.try_connect():
            time.sleep(0.01)
        got[name] = srv.receive()
        s.close()
        srv.close()
    j, t = got["jax"], got["torch"]
    assert set(j) == set(t)
    for k in ("width", "height", "train", "keep_alive", "scaling_modifier"):
        assert t[k] == j[k], k
    for k in ("viewmat", "K"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=0)
    for k, v in parse_request(msg).items():
        assert np.array_equal(t[k], v), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(dataset, model directory) the port's CLIs write."""
    root = tmp_path_factory.mktemp("viewer")
    data = write_dataset(str(root / "data"))
    return data, train_model(root, data, "rgb", color_attr="RGB",
                             view_dim=3)


def test_serve_model_on_port_0(trained):
    """Two image requests (the second at scaling_modifier 0.5) around a
    keep-alive, each frame the uint8 quantisation of `render()` of the
    camera the server decodes."""
    _, model = trained
    lp, _, _, cfg = load_config(f"{model}/config.yaml", model)
    scene = Scene(lp, cfg, load_iteration=-1, device="cpu")
    cams = orbit_cameras(2, radius=4.0, height_z=-1.5, width=40, height=32,
                         device="cpu")
    msgs = [request_message(cams[0].viewmat, cams[0].K, 40, 32),
            request_message(np.eye(4), np.eye(3), 0, 0),
            request_message(cams[1].viewmat, cams[1].K, 40, 32,
                            scaling_modifier=0.5)]
    srv = ViewerServer(port=0)
    th = threading.Thread(target=serve_model, args=(model,), kwargs=dict(
        max_requests=2, device="cpu", server=srv))
    th.start()
    s = socket.create_connection(("127.0.0.1", srv.bound_port), timeout=30)
    frames = []
    for msg in msgs:
        s.sendall(frame_message(msg))
        n = msg["resolution_x"] * msg["resolution_y"] * 3
        img, verify = _read_frame(s, n)
        assert verify == model
        frames.append(img)
    s.close()
    th.join(timeout=30)
    assert not th.is_alive()
    assert frames[1] == b""
    st = scene.train_state
    for msg, img in ((msgs[0], frames[0]), (msgs[2], frames[2])):
        cam_d = parse_request(msg)
        with torch.no_grad():
            pkg = t_render(wire_camera(cam_d, "cpu"), scene.cfg,
                           st.params.mlps, st.anchor_state(), torch.zeros(3),
                           scaling_modifier=cam_d["scaling_modifier"])
        assert int(pkg["n_dropped"]) == 0
        want = quantize(pkg["render"])
        assert want.max() > 0
        np.testing.assert_array_equal(
            np.frombuffer(img, np.uint8).reshape(want.shape), want)
    assert frames[0] != frames[2]


def test_train_cli_viewer_port(trained, tmp_path, monkeypatch):
    """`--viewer_port 0`: a client connected while the trainer runs gets a
    frame of the model being trained and the model path."""
    servers = []

    class Recorded(ViewerServer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            servers.append(self)

    monkeypatch.setattr(ttrainer_mod, "ViewerServer", Recorded)
    cam = orbit_cameras(1, radius=4.0, height_z=-1.5, width=24, height=16,
                        device="cpu")[0]
    result = {}

    def client():
        while not servers:
            time.sleep(0.01)
        s = socket.create_connection(("127.0.0.1", servers[0].bound_port),
                                     timeout=30)
        s.sendall(frame_message(request_message(cam.viewmat, cam.K, 24,
                                                16)))
        result["frame"] = _read_frame(s, 24 * 16 * 3)
        s.close()

    th = threading.Thread(target=client)
    th.start()
    out = train_model(tmp_path, trained[0], "polled", "--viewer_port", "0",
                      "--iterations", "40", color_attr="RGB", view_dim=3)
    th.join(timeout=30)
    img, verify = result["frame"]
    assert verify == out and len(img) == 24 * 16 * 3
    assert max(img) > 0
    assert servers[0].conn is None      # closed with the run


def _flagship_models():
    cfg, ts, jcams = _flagship()
    js = ts.anchor_state()
    rng = np.random.default_rng(11)
    live = (np.arange(js.capacity) < int(js.n))[:, None]
    js = js._replace(
        feat=jnp.asarray(rng.normal(size=js.feat.shape).astype(np.float32)
                         * live),
        offset=jnp.asarray(rng.normal(size=js.offset.shape)
                           .astype(np.float32) * live[:, :, None]))
    jm = mlps_from_params(ts.params)
    tst = anchor_state_from_numpy(jax.tree.map(np.asarray, js._asdict()),
                                  device="cpu")
    tm = mlps_from_numpy(**jax.tree.map(np.asarray, jm._asdict()),
                         device="cpu")
    tcfg = ModelConfig(**{f: getattr(cfg, f)
                          for f in cfg.__dataclass_fields__})
    tcam = orbit_cameras(1, radius=3.5, height_z=-1.0, width=jcams[0].width,
                         height=jcams[0].height, device="cpu")[0]
    return (cfg, jm, js, jcams[0]), (tcfg, tm, tst, tcam)


def test_render_scaling_modifier_matches_jax():
    (cfg, jm, js, jcam), (tcfg, tm, ts, tcam) = _flagship_models()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jp = j_render(jcam, cfg, jm, js, jnp.asarray(bg),
                  rasterizer="pallas_interpret", scaling_modifier=0.5)
    with torch.no_grad():
        tp = t_render(tcam, tcfg, tm, ts, torch.from_numpy(bg),
                      scaling_modifier=0.5)
        full = t_render(tcam, tcfg, tm, ts, torch.from_numpy(bg))
    assert int(tp["n_dropped"]) == int(jp["n_dropped"]) == 0
    np.testing.assert_allclose(tp["scaling"].numpy(),
                               np.asarray(jp["scaling"]), rtol=1e-6)
    np.testing.assert_allclose(tp["render"].numpy(), np.asarray(jp["render"]),
                               atol=1e-4)
    np.testing.assert_allclose(tp["render_alphas"].numpy(),
                               np.asarray(jp["render_alphas"]), atol=2e-5)
    np.testing.assert_allclose(tp["render_depth"].numpy(),
                               np.asarray(jp["render_depth"]), atol=1e-4,
                               rtol=2e-4)
    # smaller splats: less coverage than at scale 1
    assert float(tp["render_alphas"].sum()) < float(
        full["render_alphas"].sum())
    assert float(jp["render_alphas"].max()) > 0.5
