"""Remote viewer endpoint (the SIBR network-GUI protocol), the JAX
package's `viewer/server.py` (the reference's
`gaussian_renderer/network_gui.py:26-85`, polled from its train loop at
`train.py:113-127`). Wire protocol, byte for byte the JAX package's:

  client -> server: 4-byte LE length + UTF-8 JSON
      {resolution_x, resolution_y, train, fov_y, fov_x, z_near, z_far,
       rot_scale_python, keep_alive, scaling_modifier,
       view_matrix (16 floats), view_projection_matrix (16 floats)}
  server -> client: H*W*3 raw uint8 bytes, then
      4-byte LE length + ASCII verify string (the model path)

A 0x0 resolution is a keep-alive: the answer is the verify string alone.
The incoming OpenGL-style view matrix has its Y and Z columns flipped and
is transposed (`network_gui.py:73-74`) into our world->camera matrix.

`serve_model` is a blocking viewer loop over a trained model directory on
the card (K1 once per request; K3 for a 2DGS model). One departure from
the JAX package: it calibrates the instance capacity per resolution and
renders a request again with a recalibrated one when it overflowed, as
`train.evaluate.render_set` does, so it never sends a frame that dropped
instances. It may be handed a bound `ViewerServer` (port 0 included).

Spans (`horizongs_tpu_torch.tracing`, while a profiler records), each
frame's with the server's frame counter as its `request`:
`viewer.receive` (the read of a message that has begun to arrive),
`viewer.render` (the render callback, `render_request`),
`viewer.quantize` and `viewer.send`; counters `viewer.frames_quantized`
and `viewer.frames_on_card` (`ViewerServer.send_image`).
"""
from __future__ import annotations

import json
import math
import os
import socket
import time
from typing import Optional

import numpy as np
import torch

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.cli.common import load_config
from horizongs_tpu_torch.core.cameras import Camera
from horizongs_tpu_torch.data.scene import Scene
from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.ops.quantize import FrameQuantizer
from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
from horizongs_tpu_torch.render import count_render_instances, render


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client disconnected")
        buf += chunk
    return buf


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host, self.port = host, port
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)        # non-blocking accept (poll)
        self.conn: Optional[socket.socket] = None
        # messages received: the `request` of a frame's spans
        self.frames = 0
        self.quantize_on_card = FrameQuantizer()

    @property
    def bound_port(self) -> int:
        return self.listener.getsockname()[1]

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def receive(self) -> Optional[dict]:
        """One message -> `parse_request`'s camera dict, or None for the
        0x0 keep-alive resolution. The span `viewer.receive` opens once
        the message's length has arrived: a wait that ends in the poll's
        timeout is no receive."""
        head = _recv_exact(self.conn, 4)
        with tracing.span("viewer.receive", request=self.frames + 1):
            n = int.from_bytes(head, "little")
            msg = json.loads(_recv_exact(self.conn, n).decode("utf-8"))
        self.frames += 1
        return parse_request(msg)

    def send_image(self, image: Optional[np.ndarray], verify: str) -> None:
        """image (H, W, 3) float [0, 1] -> raw bytes + verify string;
        image=None sends the verify frame alone (the keep-alive reply,
        `network_gui.py:49-53`). A CUDA tensor is quantized on the card
        (`ops.quantize.FrameQuantizer`, which takes (H, W, 3) float32), an
        array or a CPU tensor by `quantize`, to the same bytes, sent in C
        order from a view of the frame. Spans `viewer.quantize` (the wait
        for the frame's last kernels, the quantize and the copy to the
        host) and `viewer.send`, one after the other; counters
        `viewer.frames_quantized` (every image frame) and
        `viewer.frames_on_card` (those quantized on the card)."""
        frame = None
        if image is not None:
            on_card = torch.is_tensor(image) and image.is_cuda
            with tracing.span("viewer.quantize", request=self.frames):
                frame = (self.quantize_on_card(image) if on_card
                         else quantize(image))
            tracing.count("viewer.frames_quantized", 1)
            if on_card:
                tracing.count("viewer.frames_on_card", 1)
        with tracing.span("viewer.send", request=self.frames):
            if frame is not None:
                self.conn.sendall(
                    memoryview(np.ascontiguousarray(frame)).cast("B"))
            self.conn.sendall(len(verify).to_bytes(4, "little"))
            self.conn.sendall(verify.encode("ascii"))

    def drop_client(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.drop_client()
        self.listener.close()

    def poll(self, render_cb, verify: str) -> None:
        """In-train poll (`train.py:114-127` semantics): with no client, one
        non-blocking accept; with one, answer a pending request with
        `render_cb(cam_dict) -> (H, W, 3)`, dropping the client on any
        protocol error. A frame's spans (`viewer.receive`, `viewer.render`
        around `render_cb`, `viewer.quantize`, `viewer.send`) share the
        frame counter as their `request`."""
        if not self.try_connect():
            return
        try:
            self.conn.settimeout(0.005)
            try:
                cam = self.receive()
            except (BlockingIOError, socket.timeout):
                return
            finally:
                self.conn.settimeout(None)
            if cam is not None:
                with tracing.span("viewer.render", request=self.frames):
                    image = render_cb(cam)
                self.send_image(image, verify)
            else:
                self.send_image(None, verify)
        except Exception:
            self.drop_client()


def parse_request(msg: dict) -> Optional[dict]:
    """A request's JSON -> dict with the camera's width, height, viewmat
    and K (numpy float32), train, keep_alive and scaling_modifier; None
    for the 0x0 keep-alive resolution."""
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    view = np.array(msg["view_matrix"], dtype=np.float32).reshape(4, 4)
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    # the incoming matrix is row-vector convention (x @ M); ours M @ x
    viewmat = view.T
    fx = width / (2.0 * math.tan(msg["fov_x"] / 2.0))
    fy = height / (2.0 * math.tan(msg["fov_y"] / 2.0))
    K = np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0],
                  [0, 0, 1]], dtype=np.float32)
    return {"width": width, "height": height, "viewmat": viewmat, "K": K,
            "train": bool(msg.get("train", True)),
            "keep_alive": bool(msg.get("keep_alive", True)),
            "scaling_modifier": float(msg.get("scaling_modifier", 1.0))}


def request_message(viewmat, K, width: int, height: int,
                    scaling_modifier: float = 1.0) -> dict:
    """The client's side: a camera's world->camera `viewmat` (4, 4) and
    intrinsics `K` (principal point at the image centre) as a request's
    JSON, the inverse of `parse_request`'s flip and transpose; width =
    height = 0 makes the keep-alive."""
    view = np.array(viewmat, dtype=np.float64).T
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    K = np.asarray(K, dtype=np.float64)
    return {"resolution_x": width, "resolution_y": height, "train": False,
            "fov_y": 2.0 * math.atan(height / (2.0 * K[1, 1])),
            "fov_x": 2.0 * math.atan(width / (2.0 * K[0, 0])),
            "z_near": 0.01, "z_far": 100.0, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": scaling_modifier,
            "view_matrix": view.flatten().tolist(),
            "view_projection_matrix": np.eye(4).flatten().tolist()}


def frame_message(msg: dict) -> bytes:
    """A request's JSON as sent: its 4-byte LE length, then the UTF-8."""
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def quantize(image) -> np.ndarray:
    """(H, W, 3) float [0, 1] (array or tensor) -> the uint8 frame sent:
    the host's path, and the plain version of `ops.quantize`'s kernel."""
    if torch.is_tensor(image):
        image = image.detach().cpu().numpy()
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)


def wire_camera(cam_d: dict, device: DeviceLike) -> Camera:
    """A received request (`ViewerServer.receive`) -> a render camera on
    `device`, its centre from the inverse of its view matrix."""
    viewmat = cam_d["viewmat"]
    center = np.linalg.inv(viewmat)[:3, 3].astype(np.float32)
    return Camera(viewmat=torch.from_numpy(np.ascontiguousarray(viewmat))
                  .to(device), K=torch.from_numpy(cam_d["K"]).to(device),
                  width=cam_d["width"], height=cam_d["height"],
                  cam_center=torch.from_numpy(center).to(device))


@torch.no_grad()
def render_request(cam_d: dict, cfg, mlps, state, background: torch.Tensor,
                   caps: dict, rasterizer: str = "cuda",
                   add_prefilter: bool = True,
                   active_sh_degree: Optional[int] = None) -> torch.Tensor:
    """The (H, W, 3) image of one request, on the model's device. `caps`
    maps (H, W) to the calibrated instance capacity (the first request's
    count x 1.5); a request that overflows it is recalibrated from itself
    and rendered again, so no frame drops instances."""
    cam = wire_camera(cam_d, state.anchor.device)
    mod = cam_d.get("scaling_modifier", 1.0)
    key = (cam.height, cam.width)

    def calibrate():
        caps[key] = suggest_instance_cap(count_render_instances(
            cam, cfg, mlps, state, add_prefilter=add_prefilter,
            scaling_modifier=mod), margin=1.5)

    def draw():
        return render(cam, cfg, mlps, state, background,
                      add_prefilter=add_prefilter, rasterizer=rasterizer,
                      instance_cap=caps[key],
                      active_sh_degree=active_sh_degree,
                      scaling_modifier=mod)

    if key not in caps:
        calibrate()
    pkg = draw()
    while int(pkg["n_dropped"]) > 0:
        calibrate()
        pkg = draw()
    return pkg["render"]


def serve_model(model_path: str, host: str = "127.0.0.1", port: int = 6009,
                rasterizer: str = "cuda", load_iteration: int = -1,
                max_requests: Optional[int] = None,
                device: DeviceLike = None,
                server: Optional[ViewerServer] = None) -> None:
    """Blocking viewer loop over a trained model directory: each image
    request is rendered on `device` (the card by default) by
    `render_request` and sent; `max_requests` image requests end it.
    `server` is a bound `ViewerServer` to answer on in place of a new one
    on host:port; it is closed at the end either way."""
    dev = resolve_device(device)
    lp, _, _, cfg = load_config(os.path.join(model_path, "config.yaml"),
                                model_path)
    scene = Scene(lp, cfg, load_iteration=load_iteration, device=dev)
    mlps = scene.train_state.params.mlps
    state = scene.train_state.anchor_state()
    background = torch.zeros(3, device=dev)
    caps = {}

    srv = server if server is not None else ViewerServer(host, port)
    served = 0
    try:
        while max_requests is None or served < max_requests:
            if not srv.try_connect():
                time.sleep(0.02)
                continue
            try:
                cam_d = srv.receive()
            except ConnectionError:
                srv.drop_client()
                continue
            if cam_d is None:
                srv.send_image(None, model_path)
                continue
            with tracing.span("viewer.render", request=srv.frames):
                image = render_request(cam_d, scene.cfg, mlps, state,
                                       background, caps,
                                       rasterizer=rasterizer)
            srv.send_image(image, model_path)
            served += 1
    finally:
        srv.close()
