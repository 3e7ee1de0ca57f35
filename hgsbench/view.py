"""Viewer cells: the program's viewer endpoint serving one client.

The table is the trained block's (aerial anchors and street levels, as
the traffic file sets them). The server side is the path `cli.view` and
the in-train viewer share: `ViewerServer.poll` answering each request with
`viewer.server.render_request` on the in-memory model. The client is a
process of its own (`hgsbench.client`) in a closed loop over a seeded
flight that descends from aerial orbit to a street and climbs back.

Set-up renders every `warmup_stride`-th request of the flight, in the
same order for every seed, through `render_request` (so the instance
capacity is calibrated on them, the same way on every seed) before
the client starts, and ends after the client's first `socket_warmup`
requests, served untimed through the socket. After the window the reference renders the sampled
requests from the requests as sent, and the frames are compared byte by
byte.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hgsbench import capture, scene, wire
from hgsbench.reference import check
from hgsbench.train import Stages

VERIFY = "hgsbench"


FLIGHT_SEED = 0


def flight(cfg: dict, traffic: dict) -> list:
    """The flight's requests: `legs` legs of `frames_per_leg` frames, each
    leg between an aerial pose (an azimuth on the ring at
    `aerial_distance`) and a street pose (a corridor), descending on even
    legs and climbing on odd ones; distance, target and field of view move
    with the log of the height. The poses are drawn from `FLIGHT_SEED`:
    the same flight for every seed."""
    _, L, sc_ = scene.block_geometry(cfg)
    W, H = traffic["width"], traffic["height"]
    F, legs = traffic["frames_per_leg"], traffic["legs"]
    corridors = 2 * (cfg["scene"]["layout"]["lots"] + 1)
    fixed = torch.Generator()
    fixed.manual_seed(FLIGHT_SEED)
    draws = torch.rand((legs // 2 + 1, 8), generator=fixed) * 2 - 1
    out = []
    for leg in range(legs):
        d = draws[leg // 2]
        az = math.pi * float(d[0])
        a_eye, a_tgt = scene.aerial_pose(
            {"scene": {"aerial_elevation_deg": [traffic["aerial_elevation_deg"]],
                       "aerial_distance": [traffic["aerial_distance"]]}},
            L, 0, az, d[1:5])
        corridor = int((float(d[5]) * 0.5 + 0.5) * corridors) % corridors
        s_eye, s_tgt = scene.street_pose(cfg, sc_, corridor,
                                         0.3 + 0.2 * float(d[6]),
                                         1.0 if d[7] > 0 else -1.0, d[5:7])
        h_a, h_s = a_eye[2], s_eye[2]
        for i in range(F):
            t = i / (F - 1)
            if leg % 2:
                t = 1.0 - t
            h = math.exp((1 - t) * math.log(h_a) + t * math.log(h_s))
            g = (h - h_s) / (h_a - h_s)
            eye = [s + g * (a - s) for a, s in zip(a_eye, s_eye)]
            tgt = [s + g * (a - s) for a, s in zip(a_tgt, s_tgt)]
            fov = math.radians(traffic["street_fov_deg"] + g * (
                traffic["aerial_fov_deg"] - traffic["street_fov_deg"]))
            vm, K = scene.lookat(eye, tgt, fov, W, H)
            out.append(wire.request_message(vm.numpy(), K.numpy(), W, H))
    return out


def start_from(requests: list, gen: torch.Generator) -> list:
    """The flight from a frame drawn from the seed, cycling: every seed
    sends the same frames, in another order."""
    start = int(torch.randint(len(requests), (1,), generator=gen,
                              device=gen.device))
    return requests[start:] + requests[:start]


def sample_indices(requests: list, n: int, gen: torch.Generator) -> list:
    """`n` request indices drawn from the seed, with the first request and
    the lowest and the highest camera of the flight among them."""
    heights = [float(np.linalg.inv(wire.parse_request(r)["viewmat"])[2, 3])
               for r in requests]
    picks = {0, int(np.argmin(heights)), int(np.argmax(heights))}
    order = torch.randperm(len(requests), generator=gen,
                           device=gen.device).tolist()
    for i in order:
        if len(picks) >= n:
            break
        picks.add(i)
    return sorted(picks)


def run(ctx) -> dict:
    from horizongs_tpu_torch.viewer.server import ViewerServer, render_request
    from hgsbench import program
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    stages = Stages(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    tables = scene.make_tables(cfg, traffic["table"], gen, dev)
    fixed = flight(cfg, traffic)
    requests = start_from(fixed, gen)
    sample = sample_indices(requests, traffic["sample_frames"], gen)
    ref_tables = scene.host_copy(tables)
    mcfg = program.model_config(cfg)
    state, mlps = program.anchor_state(tables), program.decoders(tables)
    bg = torch.zeros(3, device=dev)
    caps = {}
    stages.mark("scene_s")

    def render_cb(cam_d):
        return render_request(cam_d, mcfg, mlps, state, bg, caps)

    for r in fixed[::traffic["warmup_stride"]]:
        wire.quantize(render_cb(wire.parse_request(r)))
    req_path = os.path.join(ctx.tmpdir, "requests.jsonl")
    with open(req_path, "w") as f:
        for r in requests:
            f.write(json.dumps(r) + "\n")
    frame_dir = os.path.join(ctx.tmpdir, "frames")
    os.makedirs(frame_dir, exist_ok=True)
    stages.mark("warmup_s")

    # the window: serve the client until it hangs up
    srv = ViewerServer("127.0.0.1", 0)
    out_path = os.path.join(ctx.tmpdir, "client.json")
    spans, calls, served = [], [], [0]
    active = [False, None]
    prof = [None]

    def traced_cb(cam_d):
        if served[0] == traffic["trace_from"]:
            from torch.profiler import ProfilerActivity, profile
            prof[0] = profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
            prof[0].start()
            active[0] = True
        if served[0] == traffic["trace_from"] + traffic["trace_steps"]:
            _stop(prof, dev, ctx.tmpdir)
            active[0] = False
        active[1] = _ref_camera(cam_d, dev)
        served[0] += 1
        _sync(dev)
        t0 = time.perf_counter()
        img = render_cb(cam_d)
        _sync(dev)
        spans.append((time.perf_counter() - t0) * 1e3)
        return img

    # the client's first `socket_warmup` requests warm the socket, the
    # quantize and the send; set-up ends where the first timed one comes
    warm, seen, setup = traffic.get("socket_warmup", 0), [0], [float("nan")]
    timed = traced_cb if ctx.trace else render_cb

    def cb(cam_d):
        seen[0] += 1
        if seen[0] <= warm:
            return render_cb(cam_d)
        if seen[0] == warm + 1:
            setup[0] = time.perf_counter() - ctx.t0
        return timed(cam_d)
    hook = (capture.render_calls(calls, traffic["trace_calls"], active)
            if ctx.trace else contextlib.nullcontext())
    env = dict(os.environ, PYTHONPATH=ctx.root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    client = subprocess.Popen(
        [sys.executable, "-m", "hgsbench.client", str(srv.bound_port),
         req_path, str(ctx.seconds), out_path,
         ",".join(map(str, sample)), frame_dir, str(warm)], env=env,
        cwd=ctx.root)
    try:
        with hook:
            while client.poll() is None:
                srv.poll(cb, VERIFY)
    finally:
        if client.poll() is None:
            client.kill()
        client.wait()
        srv.close()
    if prof[0] is not None:
        _stop(prof, dev, ctx.tmpdir)
    stages.mark("window_s")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    with open(out_path) as f:
        res = json.load(f)
    times = res["times_ms"]
    out = {
        "attempted": res["sent"], "failed": res["failed"],
        "e2e": {"frame_ms_p50": _median(times),
                "peak_mem_gib": peak / 2 ** 30, "setup_s": setup[0]},
        "memory_peak_bytes": peak, "window_s": sum(times) / 1e3,
        "spans": {"render_ms": spans},
        "trace_path": (os.path.join(ctx.tmpdir, "trace.json")
                       if ctx.trace else None),
        "calls": calls,
    }
    if ctx.trace:
        out["calls"] = capture.count_calls(calls, cfg, ref_tables, None,
                                           dev)
        stages.mark("counts_s")
    del state, mlps, tables, caps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference over the sampled frames that came
    got = res["saved"]
    sent = []
    for i in got:
        with open(os.path.join(frame_dir, f"{i}.u8"), "rb") as f:
            sent.append(np.frombuffer(f.read(), dtype=np.uint8))
    ref = check.render_frames(cfg, ref_tables,
                              [wire.parse_request(requests[i]) for i in got],
                              dev)
    out["numbers"] = compare(sent, ref)
    stages.mark("reference_s")
    out["stages"] = stages.times
    out["numbers"]["_frames"] = got
    # a sampled frame that was sent in the window and never came is failed
    out["failed"] += sum(1 for i in sample
                         if i < res["sent"] and i not in got)
    return out


def compare(sent: list, ref: list) -> dict:
    """The share of the sampled frames' bytes that differ from the
    reference's (compared), and the largest difference in levels (shown
    beside it: rounding alone flips a byte by one level)."""
    if not sent:
        return {"bytes_off": 1.0, "_max_off": 255.0}
    diff = np.concatenate([np.abs(a.astype(np.int16)
                                  - b.reshape(-1).astype(np.int16))
                           for a, b in zip(sent, ref)])
    return {"bytes_off": float(np.mean(diff > 0)),
            "_max_off": float(diff.max())}


def _median(times):
    """The median of all the frames' times."""
    return float(np.percentile(times, 50)) if times else float("nan")


def _ref_camera(cam_d, dev):
    from hgsbench.reference.cameras import Camera
    vm = np.ascontiguousarray(cam_d["viewmat"])
    center = np.linalg.inv(vm)[:3, 3].astype(np.float32)
    return Camera(viewmat=torch.from_numpy(vm).to(dev),
                  K=torch.from_numpy(cam_d["K"]).to(dev),
                  width=cam_d["width"], height=cam_d["height"],
                  cam_center=torch.from_numpy(center).to(dev))


def _stop(prof, dev, tmpdir):
    if prof[0] is None:
        return
    _sync(dev)
    prof[0].stop()
    prof[0].export_chrome_trace(os.path.join(tmpdir, "trace.json"))
    prof[0] = None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
