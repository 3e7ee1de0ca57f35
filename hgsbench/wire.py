"""The SIBR network-GUI wire format, the client's side.

Copies of horizongs_tpu_torch/viewer/server.py's `request_message`,
`parse_request`, `frame_message` and `quantize` (commit 9bef012), so that
the benchmark's client and its reference never import the program:

  client -> server: 4-byte LE length + UTF-8 JSON request
  server -> client: H*W*3 raw uint8 bytes, then a 4-byte LE length and
                    the ASCII verify string
"""
from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np


def request_message(viewmat, K, width: int, height: int,
                    scaling_modifier: float = 1.0) -> dict:
    """A camera's world->camera `viewmat` (4, 4) and intrinsics `K`
    (principal point at the image centre) as a request's JSON."""
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


def parse_request(msg: dict) -> Optional[dict]:
    """A request's JSON -> the camera the server renders: width, height,
    viewmat and K (numpy float32); None for the 0x0 keep-alive."""
    width, height = msg["resolution_x"], msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    view = np.array(msg["view_matrix"], dtype=np.float32).reshape(4, 4)
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    viewmat = view.T
    fx = width / (2.0 * math.tan(msg["fov_x"] / 2.0))
    fy = height / (2.0 * math.tan(msg["fov_y"] / 2.0))
    K = np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0],
                  [0, 0, 1]], dtype=np.float32)
    return {"width": width, "height": height, "viewmat": viewmat, "K": K,
            "train": bool(msg.get("train", True)),
            "keep_alive": bool(msg.get("keep_alive", True)),
            "scaling_modifier": float(msg.get("scaling_modifier", 1.0))}


def frame_message(msg: dict) -> bytes:
    """A request's JSON as sent: its 4-byte LE length, then the UTF-8."""
    payload = json.dumps(msg).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def quantize(image) -> np.ndarray:
    """(H, W, 3) float [0, 1] (array or tensor) -> the uint8 frame sent."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    return (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)
