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
    into <model_path>/profile/trace.json

Cameras are grouped by resolution; each (H, W, capacity, active SH degree,
prefilter) combination builds one step with a calibrated instance
capacity. An overflow is counted and widens that resolution's margin
(x1.5, up to `MARGIN_CEIL`), never silent. Each iteration reads the loss
and the dropped count in one host sync.

Not ported yet: the multi-device path (the mesh, band exchange, cost-
balanced batches and sharded checkpoints; ROADMAP queue 3).
"""
from __future__ import annotations

import os
import random
import time
from collections import defaultdict
from typing import Optional, Tuple

import numpy as np
import torch

from horizongs_tpu_torch.io.checkpoints import (
    load_train_checkpoint,
    save_train_checkpoint,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
from horizongs_tpu_torch.render import count_render_instances, render
from horizongs_tpu_torch.train.densify import (
    clean_stats,
    roll_back,
    run_densify,
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
                 profile_steps: Optional[Tuple[int, int]] = None):
        self.cfg = cfg
        self.op = op
        self.pp = pp
        self.scene = scene
        self.log = logger.info if logger else print
        self.rasterizer = rasterizer
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.tb = tb_writer
        self._steps = {}
        # per-resolution capacity margins: an overflow at one resolution
        # does not rebuild the steps of the others
        self._cap_margin = defaultdict(lambda: 1.15)
        self._margin_capped = set()
        self.add_prefilter = pp.add_prefilter
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
        self.viewer = None
        self._viewer_caps = {}
        if viewer_port is not None:
            self.viewer = ViewerServer(port=viewer_port)
            self.log(f"viewer listening on :{self.viewer.bound_port}")

    def restore(self, checkpoint_path: str) -> int:
        """Resume from a training checkpoint (npz) of either package, at
        the capacity it was saved with. Returns its iteration."""
        self.state, it = load_train_checkpoint(checkpoint_path,
                                               device=self.scene.device)
        return it

    def _calib_views(self, H, W, samples: int = 6):
        """Evenly strided sample of train views at this resolution."""
        cams = [c for c in self.scene.get_train_cameras()
                if (c.height, c.width) == (H, W)]
        return cams[:: max(len(cams) // samples, 1)][:samples]

    def _calibrate_cap(self, H, W, samples: int = 6) -> Optional[int]:
        """Calibrated tile-instance capacity for (H, W): the largest count
        over sample train views x this resolution's margin, rounded to a
        geometric bucket."""
        if self.rasterizer != "cuda":
            return None
        cams = self._calib_views(H, W, samples)
        if not cams:
            return None
        st = self.state
        n = max(count_render_instances(c, self.cfg, st.params.mlps,
                                       st.anchor_state(),
                                       add_prefilter=self.add_prefilter)
                for c in cams)
        return suggest_instance_cap(n, margin=self._cap_margin[(H, W)])

    def _handle_overflow(self, res, d_inst: int, it: int) -> bool:
        """A calibrated capacity overflowed (anchors grew or moved): widen
        this resolution's margin x1.5 and drop its steps, so the next
        iteration rebuilds them recalibrated. At `MARGIN_CEIL` the step is
        kept and its overflow stays counted. Returns whether it widened."""
        widened = False
        if self._cap_margin[res] * 1.5 <= self.MARGIN_CEIL:
            self._cap_margin[res] *= 1.5
            widened = True
            self.log(f"[it {it}] {d_inst} tile instances dropped — "
                     f"recalibrating instance capacity for "
                     f"{res[1]}x{res[0]} (margin {self._cap_margin[res]:.2f})")
        elif res not in self._margin_capped:
            self._margin_capped.add(res)
            self.log(f"[it {it}] instance-capacity margin for "
                     f"{res[1]}x{res[0]} at its ceiling (margin "
                     f"{self._cap_margin[res]:.2f}) — keeping the step; "
                     f"overflow stays counted")
        self.records["overflows"].append(
            {"iteration": it, "dropped": d_inst, "resolution": res,
             "margin": self._cap_margin[res], "widened": widened})
        if widened:
            for k in [k for k in self._steps if k[:2] == res]:
                del self._steps[k]
        return widened

    def _step_fn(self, H, W):
        key = (H, W, self.state.params.anchor.shape[0],
               self.active_sh_degree, self.add_prefilter)
        if key not in self._steps:
            cap = self._calibrate_cap(H, W)
            if cap is not None:
                self.log(f"instance capacity for {W}x{H}: {cap}")
            self._steps[key] = build_train_step(
                self.cfg, self.op, H, W,
                spatial_lr_scale=self.scene.cameras_extent,
                frozen_mlps=self.scene.frozen_mlps,
                add_prefilter=self.add_prefilter,
                rasterizer=self.rasterizer,
                active_sh_degree=self.active_sh_degree,
                background=self.scene.background,
                frozen_appearance=self.scene.frozen_appearance,
                instance_cap=cap)
        return self._steps[key]

    def _pick_camera(self, stacks):
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
        return stack.pop(self.rng.randint(0, len(stack) - 1))

    def _render(self, cam):
        st = self.state
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
        self._profiler = None
        self.log("profiler trace stopped")

    @torch.no_grad()
    def _dump_vis(self, cam, it: int) -> None:
        """Side-by-side gt | render (| depth | normals) grid."""
        from horizongs_tpu_torch.train.evaluate import save_image
        from horizongs_tpu_torch.utils.viz import (
            image_grid, vis_depth, vis_normal)
        pkg = self._render(cam)
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
        every 5th train camera, logged and returned."""
        results = {}
        test = self.scene.get_test_cameras()[:max_views]
        train = self.scene.get_train_cameras()[::5][:max_views]
        for name, cams in (("test", test), ("train", train)):
            if not cams:
                continue
            l1s, psnrs = [], []
            for vi, cam in enumerate(cams):
                img = torch.clamp(self._render(cam)["render"], 0.0, 1.0)
                gt = cam.image
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img, gt)))
                # render/gt images at milestones (`train.py:348-359`)
                if vi < 3 and self.tb is not None:
                    tag = f"{name}_view_{int(cam.uid)}"
                    self.tb.add_image(f"{tag}/render",
                                      img.permute(2, 0, 1).cpu(), it)
                    self.tb.add_image(f"{tag}/ground_truth",
                                      gt.permute(2, 0, 1).cpu(), it)
            results[name] = {"l1": float(np.mean(l1s)),
                             "psnr": float(np.mean(psnrs))}
            self.log(f"[ITER {it}] Evaluating {name}: "
                     f"L1 {results[name]['l1']:.4f} "
                     f"PSNR {results[name]['psnr']:.2f}")
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
            if self.viewer is not None:
                self.viewer.poll(self._viewer_render, self.scene.model_path)
            if self.profile_steps is not None:
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
            cam = self._pick_camera(stacks)
            do_stats = in_stat_window and (
                (cam.image_type == "aerial" and pp.aerial_densify)
                or (cam.image_type == "street" and pp.street_densify))
            ct = camera_tensors(cam, do_stats=do_stats)
            step = self._step_fn(cam.height, cam.width)
            t_step = time.perf_counter()
            self.state, metrics = step(self.state, ct, it)
            # one host sync for the loss and the dropped count
            loss, d_inst = torch.stack(
                [metrics["loss"].double(),
                 metrics["n_dropped"].double()]).tolist()
            self.records["step_ms"].append(
                (time.perf_counter() - t_step) * 1e3)
            densify_cnt += int(do_stats)
            if d_inst > 0:
                self._handle_overflow((cam.height, cam.width), int(d_inst),
                                      it)
            ema_loss = 0.4 * loss + 0.6 * ema_loss if it > first_iter else loss
            history.append(loss)
            if it % progress_every == 0 or it == iterations:
                p = float(metrics["psnr"])
                self.log(f"[it {it:6d}] loss={ema_loss:.5f} psnr={p:.2f} "
                         f"anchors={int(self.state.n)} "
                         f"({(time.time() - t_start):.0f}s)")
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
                    self._densify(it)
            elif it == op.update_until:
                st = self.state
                if self.scene.base is not None:
                    st = roll_back(st, self.scene.base, cfg)
                self.state = clean_stats(st, cfg)

            # periodic train-view vis grid (`train.py:230-254`)
            if vis_step > 0 and it % vis_step == 0:
                self._dump_vis(cam, it)
            if it in test_iterations:
                self._report(it)
            if it in save_iterations:
                self.log(f"[ITER {it}] Saving Gaussians")
                self.scene.save(it, self.state)
            if it in checkpoint_iterations:
                self.log(f"[ITER {it}] Saving Checkpoint")
                save_train_checkpoint(
                    os.path.join(self.scene.model_path, f"chkpnt{it}.npz"),
                    self.state, it)
            self.records["iteration_ms"].append(
                (time.perf_counter() - t_it) * 1e3)
        if self._profiler is not None:      # the run ended inside the trace
            self._stop_profile()
        return history

    def _densify(self, it: int) -> None:
        """One epoch: roll back the fine stage's base rows, grow and
        prune, then drop every step so the next ones recalibrate their
        capacity on the new table."""
        st = self.state
        if self.scene.base is not None:
            st = roll_back(st, self.scene.base, self.cfg)
        rep = {"iteration": it, "anchors_before": int(st.n),
               "capacity_before": int(st.params.anchor.shape[0])}
        self.state = run_densify(
            self.cfg, self.op, st, it, stage=self.scene.stage,
            rng=self.np_rng, cam_infos=self.scene.cam_infos,
            weed_ratio=self.scene.weed_ratio,
            capacity_block=CAPACITY_BLOCK, report=rep)
        rep.update(anchors_after=int(self.state.n),
                   capacity_after=int(self.state.params.anchor.shape[0]))
        self.records["densify"].append(rep)
        self.log(f"[it {it}] densify: {rep['anchors_before']} -> "
                 f"{rep['anchors_after']} anchors (+{rep['added']} "
                 f"-{rep['pruned']}), capacity {rep['capacity_after']}")
        self._steps.clear()
