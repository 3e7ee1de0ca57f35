"""Spans and counters inside the port, on the profiler's clock.

**On and off.** The recorder is on exactly while a torch profiler
records on this thread (`torch.profiler.profile`: the trainer's
`profile_steps` window, the train CLI's `--profile N`, a tool's own
profiler, `chip_smoke.py`'s profiled requests). Off, a span site makes
one check and returns a shared no-op context: no allocation, no
`record_function`, no tensor op, no sync; `count` returns at once, and a
site that would compute a tensor only to count it is guarded by
`recording()`.

**Spans.** `span(name, request=None)` is a context manager. On, it
enters `torch.profiler.record_function(name)`, so the span sits in the
profiler's chrome trace beside the kernels, on the same clock, as a
`user_annotation`; it takes `time.perf_counter_ns()` at entry and exit
and, once CUDA is initialised, records a pair of timing CUDA events on
the current stream (taken from a pool that `snapshot()` refills, read
only by `snapshot()`, never on the hot path). It records its parent, the
innermost open span on this thread, and its `request` (the training
iteration, the viewer's frame number), inherited from the parent when
not given. A span is kept only if the recorder is on both at its entry
and at its exit, so a profiler started or stopped inside an open span
leaves no half span.

**Counters.** `count(name, value)` keeps an int or a 0-dim tensor; a
tensor is read at `snapshot()`.

**Reading.** `snapshot()` synchronises once, resolves the events and the
counter tensors, and returns

    {"spans": [{"name", "request", "parent", "host_ms", "device_ms"}, ...],
     "counters": {name: [value, ...]}}

with `parent` the parent span's name (None at the top) and `device_ms`
the CUDA-event interval (None without CUDA). `reset()` clears the
record. The record holds at most `CAP` spans and `CAP` counter values;
what comes beyond is counted under the counter `tracing.dropped`, never
silently lost. The trainer writes the snapshot of its profiled window
into `<model_path>/profile/spans.json`.

**The port's spans** (no span wraps a whole iteration or frame: the
`request` ties them together, and the outermost spans are the phases):
  * `train/trainer.py`: `trainer.pick`, `trainer.build_step` (child
    `trainer.calibrate`), `trainer.sync`, `trainer.densify`
  * `train/step.py`: `step.forward`, `step.backward`, `step.update`
  * `render.py` and `ops/raster_cuda.py`: `render.decode`, `render.bin`
    (children `render.project`, the projection, and `render.sh`, the SH
    colours' evaluation, only for SH colours), `render.composite`;
    counters `render.project_rows` (rows projected; also counted by the
    3DGS projection outside `render.bin`: a calibration's count, the
    sharded step's packing) and `render.project_rows_card` (those P1
    projected on the card, `ops/project3d.py`), `render.anchor_rows`,
    `render.anchors_visible` (`models/anchors.decode_neural_gaussians`),
    `render.instances`, `render.instance_cap`, and for SH colours
    `render.sh_rows` (the rows evaluated) and `render.sh_coeffs` ((d+1)^2
    at the evaluated degree)
  * `viewer/server.py`: `viewer.receive`, `viewer.render`,
    `viewer.quantize`, `viewer.send`
"""
from __future__ import annotations

import threading
import time

import torch

CAP = 200_000

_profiler_enabled = torch.autograd._profiler_enabled
_local = threading.local()


class _Off:
    """The shared context a span site returns while the recorder is
    off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """The kept spans and counter values, and the pool of CUDA event
    pairs the spans record."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.free = []           # (start, end) timing events to reuse
        self.streams = {}        # _cuda_getCurrentStream's key -> Stream
        self.reset()

    def reset(self) -> None:
        spans = getattr(self, "spans", [])
        self.free += [sp.ev for sp in spans
                      if not isinstance(sp, dict) and sp.ev is not None]
        self.spans = []          # _Span until resolved, then dicts
        self.counters = {}       # name -> [int, float or 0-dim tensor]
        self.n_values = 0
        self.dropped = 0

    def events(self):
        """A pair of timing events recorded on the current stream: the
        span's start recorded, its end to record."""
        ev = (self.free.pop() if self.free else
              (torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)))
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        torch._C._CudaEventBase.record(ev[0], stream)
        return ev, stream

    def keep_span(self, sp) -> None:
        if len(self.spans) >= self.cap:
            self.dropped += 1
            self.release(sp)
        else:
            self.spans.append(sp)

    def release(self, sp) -> None:
        if sp.ev is not None:
            self.free.append(sp.ev)

    def keep_count(self, name: str, value) -> None:
        if self.n_values >= self.cap:
            self.dropped += 1
            return
        if torch.is_tensor(value):
            value = value.detach()
        self.counters.setdefault(name, []).append(value)
        self.n_values += 1

    def snapshot(self) -> dict:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        resolved = []
        for sp in self.spans:
            if not isinstance(sp, dict):
                self.release(sp)
                sp = sp.resolve()
            resolved.append(sp)
        self.spans = resolved
        for vals in self.counters.values():
            vals[:] = [v.item() if torch.is_tensor(v) else v for v in vals]
        counters = {k: list(v) for k, v in self.counters.items()}
        if self.dropped:
            counters["tracing.dropped"] = [self.dropped]
        return {"spans": [dict(sp) for sp in self.spans],
                "counters": counters}


RECORDER = Recorder()


def _open() -> list:
    """This thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "request", "parent", "rf", "ev", "stream", "t0",
                 "t1")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = _open()
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.request is None and top is not None:
            self.request = top.request
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev = None
        if torch.cuda.is_initialized():
            self.ev, self.stream = RECORDER.events()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev is not None:
            torch._C._CudaEventBase.record(self.ev[1], self.stream)
        self.rf.__exit__(*exc)
        stack = _open()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if _profiler_enabled():
            RECORDER.keep_span(self)
        else:
            RECORDER.release(self)
        return False

    def resolve(self) -> dict:
        req = self.request
        if isinstance(req, float) and req.is_integer():
            req = int(req)
        return {"name": self.name, "request": req, "parent": self.parent,
                "host_ms": (self.t1 - self.t0) / 1e6,
                "device_ms": (self.ev[0].elapsed_time(self.ev[1])
                              if self.ev is not None else None)}


def recording() -> bool:
    """Whether the recorder is on (a profiler records on this thread)."""
    return _profiler_enabled()


def span(name: str, request=None):
    """A span named `name` around a `with` block; see the module
    docstring."""
    if _profiler_enabled():
        return _Span(name, request)
    return _OFF


def count(name: str, value) -> None:
    """Keep one value of the counter `name` (an int or a 0-dim tensor)."""
    if _profiler_enabled():
        RECORDER.keep_count(name, value)


def snapshot() -> dict:
    """The record so far; see the module docstring."""
    return RECORDER.snapshot()


def reset() -> None:
    """Clear the record."""
    RECORDER.reset()
