"""A cell of the benchmark at a size the CPU runs in seconds: the same
files, with the scene and the traffic cut down."""
from __future__ import annotations

import copy

from hgsbench import run as hrun

# street views higher than the block's (whose tiny table leaves a
# street-height view empty)
SCENE = {"anchors": 1500, "width": 64, "height": 48, "aerial_views": 6,
         "street_views": 3, "aerial_distance": [3.6, 4.2, 4.8],
         "street_eye_height": 0.08}
TRAFFIC = {
    "train": {"warmup_iterations": 3, "quantum": 1, "offset": 0,
              "min_quanta": 4, "trace_from": 1, "trace_steps": 2,
              "trace_calls": 1},
    "view": {"table": {"aerial": 800, "street_levels": [3, 4],
                       "street_per_level": 200, "street_height": 0.03},
             "width": 64, "height": 48, "frames_per_leg": 6, "legs": 2,
             "warmup_stride": 4, "socket_warmup": 2, "sample_frames": 3,
             "trace_from": 1, "trace_steps": 2, "trace_calls": 1},
}


def spec(cell: str):
    return shrink(hrun.resolve(hrun.load_manifest(), cell))


# inside the densify window, an epoch every few statistics views, with a
# threshold that the tiny scene's gradients pass, and a window that holds
# two epochs
EPOCHS = {"update_interval": 4, "densify_grad_threshold": 2e-6}


def shrink(s):
    s = copy.deepcopy(s)
    s.cfg["scene"].update(SCENE)
    kind = s.traffic["kind"]
    s.traffic.update(TRAFFIC[kind])
    if kind == "train":
        s.traffic["table"] = {"aerial": SCENE["anchors"]}
        op = s.cfg["yaml"]["optim_params"]
        if op["update_from"] < s.traffic["first_iter"] < op["update_until"]:
            op.update(EPOCHS)
            s.traffic["min_quanta"] = 16
    return s
