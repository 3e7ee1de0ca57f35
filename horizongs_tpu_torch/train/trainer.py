"""The trainer: the host-side loop around the training step.

The JAX package's `train/trainer.py` on one device (its port of the
reference trainer, `train.py:83-285`):
  * aerial/street-balanced camera sampling (`camera_proportion` "a-s",
    `train.py:134-148`), from the same host generators as the JAX trainer
    (`random.Random(seed)`, `np.random.default_rng(seed)`), so both pick
    the same views
  * densification statistics gated per view type
    (`aerial_densify`/`street_densify`, `train.py:259-260`)
  * densify epochs counted by statistics views, inside
    (update_from, update_until), with the fine stage's rollback before
    each epoch and a final rollback + statistics clean at update_until
    (`train.py:256-273`); the step is rebuilt after every epoch, with an
    instance capacity calibrated on the new table
  * SH degree raised every 1000 iterations (`update_learning_rate` tail)
  * the frustum prefilter switched off for the last `no_prefilter_step`
    iterations
  * periodic saves, checkpoints, milestone reports and vis dumps
  * the in-train viewer poll (`viewer_port`): one non-blocking accept per
    iteration while no client is connected, else one request answered
    (`train.py:113-127`)
  * a `torch.profiler` trace of `profile_steps` = (first, n) iterations
    into <model_path>/profile/trace.json; while it records, the port's
    spans (`horizongs_tpu_torch.tracing`) are on, and their record goes
    beside it into profile/spans.json. The trainer's spans, each with the
    iteration as its `request`: `trainer.pick` (the camera pick and
    `camera_tensors`), `trainer.build_step` (a step's build, child
    `trainer.calibrate` around its capacity, band-bound and band-cap
    calibrations), `trainer.sync` (the one read of the loss and the
    dropped counts, where the host waits for the device) and
    `trainer.densify` (an epoch: the fine stage's roll-back and
    `run_densify`, whose phases' ms go into `records["densify"]`); the
    step adds `step.forward`, `step.backward`, `step.update`
  * a wandb run (`wandb_run`, rank 0): the JAX trainer's keys at its
    steps (the loss, PSNR and anchor count at each progress line, each
    milestone evaluation's L1 and PSNR and its first views' renders)

Cameras are grouped by resolution; each (H, W, capacity, active SH degree,
prefilter) combination builds one step with a calibrated instance
capacity. An overflow is counted and widens that resolution's margin
(x1.5, up to `MARGIN_CEIL`), never silent. Each iteration reads the loss
and the dropped count in one host sync.

With a mesh (`parallel/mesh.py`), the JAX trainer's multi-device path:
each rank holds its slice of the anchor rows (`parallel/step.shard_state`,
the capacity padded to divide "model") and trains through the sharded step
on batches of n_data views (`_pick_batch`), with per-band instance and
band-exchange capacities calibrated on the whole table; densify epochs
gather the state and run on every rank (`densify.run_densify_sharded`);
checkpoints are sharded directories by default. Every rank runs the same
picks from the same seed; rank 0 alone writes files. The cost-balanced
batch fill keys each view's cost by (uid, H, W) and counts a view with no
cost at the leader's resolution as infinitely far, where the JAX trainer
takes it for a perfect match (ROADMAP §3).
"""
from __future__ import annotations

import json
import math
import os
import random
import time
from collections import defaultdict
from typing import Optional, Tuple

import numpy as np
import torch

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.io.checkpoints import (
    load_sharded_checkpoint,
    load_train_checkpoint,
    save_sharded_checkpoint,
    save_train_checkpoint,
    sharded_checkpoint_capacity,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
from horizongs_tpu_torch.render import count_render_instances, render
from horizongs_tpu_torch.train.densify import (
    clean_stats,
    pad_state_capacity,
    roll_back,
    run_densify,
    run_densify_sharded,
)
from horizongs_tpu_torch.train.losses import l1_loss, psnr
from horizongs_tpu_torch.train.step import build_train_step, camera_tensors
from horizongs_tpu_torch.viewer.server import ViewerServer, render_request

# densify repack block: capacities grow in multiples of this
CAPACITY_BLOCK = 4096


class Trainer:
    # recalibration-margin ceiling: growth stops once another 1.5x
    # widening would exceed it (on the 1.15 * 1.5^k schedule the last
    # margin reached is 8.73); past it the step is kept and the overflow
    # stays counted
    MARGIN_CEIL = 8 * 1.25

    def __init__(self, cfg: ModelConfig, op, pp, scene, logger=None,
                 rasterizer: str = "cuda", seed: int = 0, tb_writer=None,
                 viewer_port: Optional[int] = None,
                 profile_steps: Optional[Tuple[int, int]] = None,
                 mesh=None, band_cap: Optional[int] = None,
                 checkpoint_format: str = "npz",
                 balanced_bands: Optional[bool] = None,
                 balanced_batches: Optional[bool] = None, wandb_run=None):
        self.cfg = cfg
        self.op = op
        self.pp = pp
        self.scene = scene
        self.log = logger.info if logger else print
        self.rasterizer = rasterizer
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.tb = tb_writer
        self.wandb = wandb_run
        self._steps = {}
        # per-resolution capacity margins: an overflow at one resolution
        # does not rebuild the steps of the others
        self._cap_margin = defaultdict(lambda: 1.15)
        self._margin_capped = set()
        self.add_prefilter = pp.add_prefilter
        # the mesh path: a `parallel.mesh.Mesh` ("data" x "model") puts the
        # trainer on the sharded step
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.band_cap = band_cap
        # the band-exchange margin, apart from the instance margin, so an
        # undersized band_cap recalibrates the exchange, not the list
        self._band_margin = defaultdict(lambda: 1.25)
        # load-balanced band boundaries are opt-in, as in the JAX trainer
        self.balanced_bands = bool(balanced_bands)
        # cost-balanced data-parallel batches, on by default under a mesh
        self.balanced_batches = (mesh is not None if balanced_batches is None
                                 else balanced_batches)
        self._view_costs = {}           # (uid, H, W) -> instance count
        self._cost_res_done = set()
        self.checkpoint_format = checkpoint_format
        if mesh is not None:
            if viewer_port is not None:
                raise ValueError("the in-train viewer is not served under a "
                                 "mesh")
            from horizongs_tpu_torch.parallel.collectives import broadcast
            from horizongs_tpu_torch.parallel.step import shard_state
            # one background for every rank (a random one is drawn per
            # process)
            scene.background = broadcast(scene.background, 0)
            n_model = mesh.shape["model"]
            C = int(scene.train_state.params.anchor.shape[0])
            if C % n_model:
                scene.train_state = pad_state_capacity(
                    scene.train_state, -(-C // n_model) * n_model)
                self.log(f"padded anchor capacity {C} -> "
                         f"{scene.train_state.params.anchor.shape[0]} "
                         f"(divisible by model={n_model})")
            scene.train_state = shard_state(scene.train_state, mesh)
        self.state = scene.train_state
        self.active_sh_degree = 0 if cfg.max_sh_degree is not None else None
        if scene.stage == "fine":
            self.active_sh_degree = cfg.max_sh_degree
        # what the loop did, per iteration and per event, for the caller
        # to read: the host-clock ms of the whole iteration and of the
        # step (its call and the read of its loss), the densify epochs'
        # reports and the overflows
        self.records = {"iteration_ms": [], "step_ms": [], "densify": [],
                        "overflows": []}
        # (first iteration, iterations) of a torch.profiler trace
        self.profile_steps = profile_steps
        self._profiler = None
        # the iteration under way: the `request` of the step build's span
        self._iteration = None
        self.viewer = None
        self._viewer_caps = {}
        if viewer_port is not None:
            self.viewer = ViewerServer(port=viewer_port)
            self.log(f"viewer listening on :{self.viewer.bound_port}")

    def _host_state(self):
        """The whole state (gathered over "model" under a mesh: every rank
        must call it), for densify epochs, saves, checkpoints and
        evaluation."""
        if self.mesh is None:
            return self.state
        from horizongs_tpu_torch.parallel.step import unshard_state
        return unshard_state(self.state, self.mesh)

    def _capacity_block(self) -> int:
        """The densify repack block: keeps the capacity divisible by the
        mesh's "model" axis."""
        if self.mesh is None:
            return CAPACITY_BLOCK
        return math.lcm(CAPACITY_BLOCK, self.mesh.shape["model"])

    def _place_state(self, host_state):
        """A whole state -> the training placement (this rank's slice
        under a mesh)."""
        if self.mesh is None:
            return host_state
        from horizongs_tpu_torch.parallel.step import shard_state
        return shard_state(host_state, self.mesh)

    def restore(self, checkpoint_path: str) -> int:
        """Resume from a training checkpoint: an npz of either package or
        a sharded directory of any mesh shape, at the capacity it was
        saved with, re-padded where that no longer divides the mesh's
        "model" axis. Returns its iteration."""
        dev = self.scene.device
        n_model = self.mesh.shape["model"] if self.mesh is not None else 1
        if os.path.isdir(checkpoint_path):
            C = sharded_checkpoint_capacity(checkpoint_path)
            if self.mesh is not None and C % n_model == 0:
                self.state, it = load_sharded_checkpoint(
                    checkpoint_path, device=dev, mesh=self.mesh)
                return it
            host, it = load_sharded_checkpoint(checkpoint_path, device=dev)
        else:
            host, it = load_train_checkpoint(checkpoint_path, device=dev)
        C = int(host.params.anchor.shape[0])
        if C % n_model:
            host = pad_state_capacity(host, -(-C // n_model) * n_model)
            self.log(f"re-padded restored capacity {C} -> "
                     f"{int(host.params.anchor.shape[0])} (divisible by "
                     f"model={n_model})")
        self.state = self._place_state(host)
        return it

    def _calib_views(self, H, W, samples: int = 6):
        """Evenly strided sample of train views at this resolution."""
        cams = [c for c in self.scene.get_train_cameras()
                if (c.height, c.width) == (H, W)]
        return cams[:: max(len(cams) // samples, 1)][:samples]

    def _calib_host_inputs(self):
        """(decoders, anchor state) of the whole table, gathered once for
        every calibration of one step build."""
        st = self._host_state()
        return st.params.mlps, st.anchor_state()

    def _calibrate_cap(self, H, W, samples: int = 6, host=None,
                       band_bounds=None) -> Optional[int]:
        """Calibrated tile-instance capacity for (H, W): the largest count
        over sample train views x this resolution's margin, rounded to a
        geometric bucket; under a mesh, the largest band's count with its
        halo rows (`parallel.step.count_band_instances`, at these band
        bounds), where the JAX trainer takes the view's / n_model."""
        if self.rasterizer != "cuda":
            return None
        cams = self._calib_views(H, W, samples)
        if not cams:
            return None
        mlps, astate = host if host is not None else self._calib_host_inputs()
        if self.mesh is not None:
            from horizongs_tpu_torch.parallel.step import (
                count_band_instances)
            n = max(max(count_band_instances(
                c, self.cfg, mlps, astate, self.mesh.shape["model"],
                add_prefilter=self.add_prefilter, band_bounds=band_bounds))
                for c in cams)
        else:
            n = max(count_render_instances(c, self.cfg, mlps, astate,
                                           add_prefilter=self.add_prefilter)
                    for c in cams)
        return suggest_instance_cap(n, margin=self._cap_margin[(H, W)])

    def _calibrate_band_bounds(self, H, W, samples: int = 6, host=None):
        """Load-balanced band boundaries for (H, W) from the tile-row loads
        summed over sample train views (`suggest_band_bounds`); None
        (uniform) unless `balanced_bands`."""
        if (not self.balanced_bands or self.mesh is None
                or self.mesh.shape["model"] == 1):
            return None
        from horizongs_tpu_torch.parallel.step import count_view_row_loads
        from horizongs_tpu_torch.parallel.tile_exchange import (
            suggest_band_bounds)
        cams = self._calib_views(H, W, samples)
        if not cams:
            return None
        mlps, astate = host if host is not None else self._calib_host_inputs()
        loads = sum(count_view_row_loads(
            c, self.cfg, mlps, astate,
            add_prefilter=self.add_prefilter).cpu().numpy() for c in cams)
        bounds = suggest_band_bounds(loads, self.mesh.shape["model"])
        self.log(f"balanced band bounds for {W}x{H}: {bounds} (tile rows)")
        return bounds

    def _calibrate_band_cap(self, H, W, samples: int = 6, band_bounds=None,
                            host=None) -> Optional[int]:
        """The band exchange's record slots per (source rank, band): the
        most routed over sample train views x the band margin, rounded to
        a geometric bucket (`suggest_band_cap`); an explicit `band_cap`
        wins until it overflows."""
        if self.mesh is None or self.mesh.shape["model"] == 1:
            return None
        if self.band_cap is not None:
            return self.band_cap
        from horizongs_tpu_torch.parallel.step import count_band_records
        from horizongs_tpu_torch.parallel.tile_exchange import (
            suggest_band_cap)
        cams = self._calib_views(H, W, samples)
        if not cams:
            return None
        mlps, astate = host if host is not None else self._calib_host_inputs()
        n = max(count_band_records(c, self.cfg, mlps, astate,
                                   self.mesh.shape["model"],
                                   add_prefilter=self.add_prefilter,
                                   band_bounds=band_bounds) for c in cams)
        return suggest_band_cap(n, margin=self._band_margin[(H, W)])

    def _widen(self, margins: dict, res, what: str, dropped: int,
               it: int) -> bool:
        """Widen one margin x1.5 up to `MARGIN_CEIL`; at the ceiling log
        once that the step is kept."""
        if margins[res] * 1.5 <= self.MARGIN_CEIL:
            margins[res] *= 1.5
            self.log(f"[it {it}] {dropped} {what} dropped — recalibrating "
                     f"for {res[1]}x{res[0]} (margin {margins[res]:.2f})")
            return True
        if (what, res) not in self._margin_capped:
            self._margin_capped.add((what, res))
            self.log(f"[it {it}] {what} margin for {res[1]}x{res[0]} at "
                     f"its ceiling (margin {margins[res]:.2f}) — keeping "
                     f"the step; overflow stays counted")
        return False

    def _handle_overflow(self, res, d_inst: int, it: int,
                         d_exch: int = 0) -> bool:
        """A calibrated capacity overflowed (anchors grew or moved): widen
        the matching margin of this resolution x1.5 — the instance list's
        for dropped instances, the band exchange's for dropped records —
        and drop its steps, so the next iteration rebuilds them
        recalibrated. At `MARGIN_CEIL` the step is kept and its overflow
        stays counted. Returns whether a margin widened."""
        widened = False
        if d_inst > 0:
            widened |= self._widen(self._cap_margin, res, "tile instances",
                                   d_inst, it)
        if d_exch > 0:
            if self.band_cap is not None:
                self.log(f"[it {it}] explicit band_cap {self.band_cap} "
                         f"overflowed — switching to measured calibration")
                self.band_cap = None
            widened |= self._widen(self._band_margin, res,
                                   "band-exchange records", d_exch, it)
        self.records["overflows"].append(
            {"iteration": it, "dropped": d_inst, "dropped_exchange": d_exch,
             "resolution": res, "margin": self._cap_margin[res],
             "band_margin": self._band_margin[res], "widened": widened})
        if widened:
            for k in [k for k in self._steps if k[:2] == res]:
                del self._steps[k]
        return widened

    def _step_fn(self, H, W):
        key = (H, W, self.state.params.anchor.shape[0],
               self.active_sh_degree, self.add_prefilter)
        if key not in self._steps:
            with tracing.span("trainer.build_step", request=self._iteration):
                self._steps[key] = self._build_step(H, W)
        return self._steps[key]

    def _build_step(self, H, W):
        """The step for (H, W), its capacities calibrated on the current
        table."""
        with tracing.span("trainer.calibrate"):
            host = self._calib_host_inputs()
            bounds = self._calibrate_band_bounds(H, W, host=host)
            cap = self._calibrate_cap(H, W, host=host, band_bounds=bounds)
            band_cap = (None if self.mesh is None else
                        self._calibrate_band_cap(H, W, band_bounds=bounds,
                                                 host=host))
        if cap is not None:
            self.log(f"instance capacity for {W}x{H}: {cap}")
        kw = dict(spatial_lr_scale=self.scene.cameras_extent,
                  frozen_mlps=self.scene.frozen_mlps,
                  add_prefilter=self.add_prefilter,
                  active_sh_degree=self.active_sh_degree,
                  background=self.scene.background,
                  frozen_appearance=self.scene.frozen_appearance,
                  instance_cap=cap)
        if self.mesh is None:
            return build_train_step(self.cfg, self.op, H, W,
                                    rasterizer=self.rasterizer, **kw)
        # the sharded step composites through the record boundary (K1/K2,
        # K3/K4): the dense oracle has none to exchange
        from horizongs_tpu_torch.parallel.step import build_sharded_train_step
        if band_cap is not None:
            self.log(f"band-exchange capacity for {W}x{H}: {band_cap}")
        return build_sharded_train_step(self.cfg, self.op, self.mesh, H, W,
                                        band_cap=band_cap,
                                        band_bounds=bounds, **kw)

    def _ensure_view_costs(self, H, W) -> None:
        """Each train view's tile-instance count at (H, W), keyed by (uid,
        H, W): the batch fill's cost. Computed once per resolution (the
        dealing needs the views' order, a property of their poses; it is
        not refreshed after densify, ROADMAP §3)."""
        if (H, W) in self._cost_res_done:
            return
        self._cost_res_done.add((H, W))
        cams = [c for c in self.scene.get_train_cameras()
                if (c.height, c.width) == (H, W)]
        self.log(f"costing {len(cams)} train views at {W}x{H} for the "
                 f"batch fill")
        mlps, astate = self._calib_host_inputs()
        for c in cams:
            self._view_costs[(int(c.uid), H, W)] = count_render_instances(
                c, self.cfg, mlps, astate, add_prefilter=self.add_prefilter)

    def _pick_camera(self, stacks, cost_hint=None, res=None):
        pp = self.pp
        if pp.camera_balance:
            if not stacks["aerial"]:
                stacks["aerial"] = [c for c in self.scene.get_train_cameras()
                                    if c.image_type == "aerial"]
            if not stacks["street"]:
                stacks["street"] = [c for c in self.scene.get_train_cameras()
                                    if c.image_type == "street"]
            a, s = pp.camera_proportion.split("-")
            have_a, have_s = bool(stacks["aerial"]), bool(stacks["street"])
            r = float(a) / (float(a) + float(s))
            if have_a and (not have_s or self.np_rng.random() < r):
                stack = stacks["aerial"]
            else:
                stack = stacks["street"]
        else:
            if not stacks["all"]:
                stacks["all"] = list(self.scene.get_train_cameras())
            stack = stacks["all"]
        if cost_hint is not None:
            # the cost-nearest fill pick: a view with no cost at the
            # leader's resolution is infinitely far; with none costed, the
            # random pop
            costed = [j for j in range(len(stack))
                      if (int(stack[j].uid), *res) in self._view_costs]
            if costed:
                i = min(costed, key=lambda j: abs(self._view_costs[
                    (int(stack[j].uid), *res)] - cost_hint))
                return stack.pop(i)
        return stack.pop(self.rng.randint(0, len(stack) - 1))

    def _pick_batch(self, stacks, n: int):
        """n views of one resolution for a data-parallel step, with their
        loss weights. The leader follows the sampling rules; with
        `balanced_batches` the other n-1 are the views of the nearest
        cost (the step waits on its heaviest view). Views of another
        resolution drawn on the way go back to their stacks. If the
        dataset cannot fill the batch at this resolution, the picks repeat
        and a view repeated k times weighs 1/k."""
        cams = [self._pick_camera(stacks)]
        H, W = cams[0].height, cams[0].width
        hint = None
        if self.balanced_batches and n > 1:
            self._ensure_view_costs(H, W)
            hint = self._view_costs.get((int(cams[0].uid), H, W))
        putback, tries = [], 0
        while len(cams) < n and tries < 8 * n:
            c = self._pick_camera(stacks, cost_hint=hint, res=(H, W))
            tries += 1
            if (c.height, c.width) == (H, W):
                cams.append(c)
            else:
                putback.append(c)
        for c in putback:
            stacks[c.image_type if self.pp.camera_balance else "all"].append(c)
        weights = [1.0] * n
        if len(cams) < n:
            if not getattr(self, "_warned_batch_fill", False):
                self.log(f"only {len(cams)} cameras at {W}x{H} — repeating "
                         f"views (weighted 1/k) to fill the {n}-view batch")
                self._warned_batch_fill = True
            k = len(cams)
            cams = [cams[i % k] for i in range(n)]
            counts = [sum(1 for j in range(n) if j % k == i % k)
                      for i in range(n)]
            weights = [1.0 / c for c in counts]
        return cams, weights

    def _render(self, cam, st=None):
        st = st if st is not None else self._host_state()
        return render(cam, self.cfg, st.params.mlps, st.anchor_state(),
                      self.scene.background,
                      add_prefilter=self.add_prefilter,
                      active_sh_degree=self.active_sh_degree,
                      rasterizer=self.rasterizer)

    def _viewer_render(self, cam_d: dict) -> torch.Tensor:
        """Render callback of the in-train viewer poll: the current model
        at the trainer's prefilter flag and SH degree, with the request's
        scaling modifier, its capacity calibrated per resolution."""
        st = self.state
        return render_request(cam_d, self.cfg, st.params.mlps,
                              st.anchor_state(), self.scene.background,
                              self._viewer_caps, rasterizer=self.rasterizer,
                              add_prefilter=self.add_prefilter,
                              active_sh_degree=self.active_sh_degree)

    def _profile(self, it: int) -> None:
        """Start the trace at its first iteration, stop and write it after
        its last (the JAX trainer's `train/trainer.py:638-648`)."""
        p0, pn = self.profile_steps
        if it == p0 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.scene.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.log("profiler trace start -> "
                     f"{os.path.join(self.scene.model_path, 'profile')}")
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif it >= p0 + pn and self._profiler is not None:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)
        self._profiler.stop()
        out = os.path.join(self.scene.model_path, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
        with open(os.path.join(out, "spans.json"), "w") as f:
            json.dump(tracing.snapshot(), f)
        self._profiler = None
        self.log("profiler trace stopped")

    @torch.no_grad()
    def _dump_vis(self, cam, it: int) -> None:
        """Side-by-side gt | render (| depth | normals) grid (rank 0)."""
        from horizongs_tpu_torch.train.evaluate import save_image
        from horizongs_tpu_torch.utils.viz import (
            image_grid, vis_depth, vis_normal)
        st = self._host_state()
        if not self.is_main:
            return
        pkg = self._render(cam, st)
        panels = [cam.image.cpu().numpy(), pkg["render"].cpu().numpy()]
        if pkg.get("render_depth") is not None:
            panels.append(vis_depth(pkg["render_depth"].cpu().numpy()[..., 0]))
        if pkg.get("render_normals") is not None:
            panels.append(vis_normal(pkg["render_normals"].cpu().numpy()))
        out_dir = os.path.join(self.scene.model_path, "vis")
        os.makedirs(out_dir, exist_ok=True)
        save_image(os.path.join(out_dir, f"iter_{it:06d}.png"),
                   image_grid(panels, cols=2))

    @torch.no_grad()
    def _report(self, it: int, max_views: int = 5) -> dict:
        """In-train milestone evaluation (`training_report`,
        `train.py:309-383`): L1/PSNR over a sample of test cameras and
        every 5th train camera, logged and returned (by rank 0)."""
        results = {}
        st = self._host_state()
        if not self.is_main:
            return results
        test = self.scene.get_test_cameras()[:max_views]
        train = self.scene.get_train_cameras()[::5][:max_views]
        for name, cams in (("test", test), ("train", train)):
            if not cams:
                continue
            l1s, psnrs = [], []
            for vi, cam in enumerate(cams):
                img = torch.clamp(self._render(cam, st)["render"], 0.0, 1.0)
                gt = cam.image
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img, gt)))
                # render/gt images at milestones (`train.py:348-359`)
                tag = f"{name}_view_{int(cam.uid)}"
                if vi < 3 and self.tb is not None:
                    self.tb.add_image(f"{tag}/render",
                                      img.permute(2, 0, 1).cpu(), it)
                    self.tb.add_image(f"{tag}/ground_truth",
                                      gt.permute(2, 0, 1).cpu(), it)
                if vi < 3 and self.wandb is not None:
                    import wandb
                    self.wandb.log({f"{tag}/render":
                                    wandb.Image(img.cpu().numpy())}, step=it)
            results[name] = {"l1": float(np.mean(l1s)),
                             "psnr": float(np.mean(psnrs))}
            self.log(f"[ITER {it}] Evaluating {name}: "
                     f"L1 {results[name]['l1']:.4f} "
                     f"PSNR {results[name]['psnr']:.2f}")
            if self.wandb is not None:
                self.wandb.log({f"{name}_l1": results[name]["l1"],
                                f"{name}_psnr": results[name]["psnr"]},
                               step=it)
            if self.tb is not None:
                self.tb.add_scalar(f"{name}/l1", results[name]["l1"], it)
                self.tb.add_scalar(f"{name}/psnr", results[name]["psnr"],
                                   it)
        return results

    def train(self, iterations: Optional[int] = None,
              save_iterations=(), checkpoint_iterations=(),
              test_iterations=(), first_iter: int = 1,
              progress_every: int = 50):
        """Iterations `first_iter`..`iterations`; returns the loss of each."""
        op, pp, cfg = self.op, self.pp, self.cfg
        iterations = iterations or op.iterations
        stacks = defaultdict(list)
        ema_loss = 0.0
        densify_cnt = 0
        densify_epochs = 0
        history = []
        t_start = time.time()
        n_noprefilter = int(getattr(pp, "no_prefilter_step", 0) or 0)
        vis_step = int(getattr(pp, "vis_step", 0) or 0)

        for it in range(first_iter, iterations + 1):
            t_it = time.perf_counter()
            self._iteration = it
            if self.viewer is not None:
                self.viewer.poll(self._viewer_render, self.scene.model_path)
            if self.profile_steps is not None and self.is_main:
                self._profile(it)
            # drop the frustum prefilter for the last no_prefilter_step
            # iterations (`train.py:280-281`)
            if (self.add_prefilter and n_noprefilter > 0
                    and it >= iterations - n_noprefilter):
                self.add_prefilter = False
                self.log(f"[it {it}] prefilter disabled for the final "
                         f"{n_noprefilter} iterations")

            # SH degree progression (`update_learning_rate`, every 1000)
            if (self.active_sh_degree is not None and it % 1000 == 0
                    and self.scene.stage != "fine"
                    and self.active_sh_degree < cfg.max_sh_degree):
                self.active_sh_degree += 1

            in_stat_window = op.start_stat < it < op.update_until

            def gate(c):
                return in_stat_window and (
                    (c.image_type == "aerial" and pp.aerial_densify)
                    or (c.image_type == "street" and pp.street_densify))

            with tracing.span("trainer.pick", request=it):
                if self.mesh is None:
                    cam = self._pick_camera(stacks)
                    ct = camera_tensors(cam, do_stats=gate(cam))
                    n_stat_views = int(gate(cam))
                else:
                    cams, wts = self._pick_batch(stacks,
                                                 self.mesh.shape["data"])
                    cam = cams[0]
                    ct = [camera_tensors(c, do_stats=gate(c), loss_weight=w)
                          for c, w in zip(cams, wts)]
                    n_stat_views = sum(int(gate(c)) for c in cams)
            step = self._step_fn(cam.height, cam.width)
            t_step = time.perf_counter()
            self.state, metrics = step(self.state, ct, it)
            # one host sync for the loss and the dropped counts
            with tracing.span("trainer.sync", request=it):
                zero = torch.zeros((), device=metrics["loss"].device)
                loss, d_inst, d_exch = torch.stack(
                    [metrics["loss"].double(),
                     metrics.get("n_dropped_instances",
                                 metrics["n_dropped"]).double(),
                     metrics.get("n_dropped_exchange", zero).double()]
                ).tolist()
            self.records["step_ms"].append(
                (time.perf_counter() - t_step) * 1e3)
            densify_cnt += n_stat_views
            if d_inst > 0 or d_exch > 0:
                self._handle_overflow((cam.height, cam.width), int(d_inst),
                                      it, int(d_exch))
            ema_loss = 0.4 * loss + 0.6 * ema_loss if it > first_iter else loss
            history.append(loss)
            if it % progress_every == 0 or it == iterations:
                p = float(metrics["psnr"])
                self.log(f"[it {it:6d}] loss={ema_loss:.5f} psnr={p:.2f} "
                         f"anchors={int(self.state.n)} "
                         f"({(time.time() - t_start):.0f}s)")
                if self.wandb is not None:
                    self.wandb.log({"train_total_loss": loss, "psnr": p,
                                    "anchors": int(self.state.n)}, step=it)
                if self.tb is not None:
                    # reference tensorboard scalars (`train.py:309-316`)
                    self.tb.add_scalar("train/total_loss", loss, it)
                    self.tb.add_scalar("train/psnr", p, it)
                    self.tb.add_scalar("train/anchors", int(self.state.n),
                                       it)
                    self.tb.add_scalar(
                        "train/iter_time",
                        (time.time() - t_start) / max(it - first_iter + 1, 1),
                        it)

            # densification epochs (`train.py:256-273`), counted by the
            # statistics views (not raw iterations), so with aerial
            # densify only and a 2-1 proportion an epoch fires about every
            # 1.5 x update_interval iterations; once per interval crossing
            if in_stat_window:
                if (op.densification and it > op.update_from
                        and densify_cnt // op.update_interval
                        > densify_epochs):
                    densify_epochs = densify_cnt // op.update_interval
                    with tracing.span("trainer.densify", request=it):
                        self._densify(it)
            elif it == op.update_until:
                st = self._host_state()
                if self.scene.base is not None:
                    st = roll_back(st, self.scene.base, cfg)
                self.state = self._place_state(clean_stats(st, cfg))

            # periodic train-view vis grid (`train.py:230-254`)
            if vis_step > 0 and it % vis_step == 0:
                self._dump_vis(cam, it)
            if it in test_iterations:
                self._report(it)
            if it in save_iterations:
                self.log(f"[ITER {it}] Saving Gaussians")
                host = self._host_state()
                if self.is_main:
                    self.scene.save(it, host)
            if it in checkpoint_iterations:
                self.log(f"[ITER {it}] Saving Checkpoint")
                self.save_checkpoint(it)
            self.records["iteration_ms"].append(
                (time.perf_counter() - t_it) * 1e3)
        if self._profiler is not None:      # the run ended inside the trace
            self._stop_profile()
        return history

    def save_checkpoint(self, it: int) -> str:
        """`chkpnt{it}.npz` (rank 0 writes the gathered state) or, with
        `checkpoint_format="sharded"`, the directory
        `chkpnt{it}_sharded/` (each rank its rows). Returns the path."""
        if self.checkpoint_format == "sharded":
            path = os.path.join(self.scene.model_path,
                                f"chkpnt{it}_sharded")
            mesh = self.mesh
            if mesh is None:
                from horizongs_tpu_torch.parallel.mesh import make_mesh
                mesh = make_mesh(1, 1, device=self.scene.device)
            save_sharded_checkpoint(path, self.state, it, mesh)
            return path
        path = os.path.join(self.scene.model_path, f"chkpnt{it}.npz")
        host = self._host_state()
        if self.is_main:
            save_train_checkpoint(path, host, it)
        return path

    def _densify(self, it: int) -> None:
        """One epoch: roll back the fine stage's base rows, grow and
        prune, then drop every step so the next ones recalibrate their
        capacity on the new table. Under a mesh every rank runs the epoch
        on the gathered state (`run_densify_sharded`)."""
        st = self.state
        n_before = int(st.n)
        C_before = int(st.params.anchor.shape[0])
        if self.mesh is not None:
            C_before *= self.mesh.shape["model"]
        rep = {"iteration": it, "anchors_before": n_before,
               "capacity_before": C_before}
        kw = dict(stage=self.scene.stage, rng=self.np_rng,
                  cam_infos=self.scene.cam_infos,
                  weed_ratio=self.scene.weed_ratio,
                  capacity_block=self._capacity_block(), report=rep)
        if self.mesh is None:
            if self.scene.base is not None:
                st = roll_back(st, self.scene.base, self.cfg)
            self.state = run_densify(self.cfg, self.op, st, it, **kw)
            C_after = int(self.state.params.anchor.shape[0])
        else:
            self.state = run_densify_sharded(
                self.cfg, self.op, st, self.mesh, it, base=self.scene.base,
                **kw)
            C_after = (int(self.state.params.anchor.shape[0])
                       * self.mesh.shape["model"])
        rep.update(anchors_after=int(self.state.n), capacity_after=C_after)
        self.records["densify"].append(rep)
        self.log(f"[it {it}] densify: {rep['anchors_before']} -> "
                 f"{rep['anchors_after']} anchors (+{rep['added']} "
                 f"-{rep['pruned']}), capacity {rep['capacity_after']}")
        self._steps.clear()
