"""The program's own spans and counters, for the per-layer readers.

The second module of the benchmark, after `program.py`, that imports the
program: the cell's temporary directory, and the profiler's raw trace in
it, is gone by the time the readers run, so they read the record that the
program's recorder (`horizongs_tpu_torch.tracing`) kept in this process.
The recorder is on exactly while a profiler records, so the record holds
the traced stretch alone (the trainer's `profile_steps` window, the viewer
cell's profiled frames). It is read once per run, with
`tracing.snapshot()`, and kept on the run as `run.program_spans`. A
program without the recorder gives an empty record, and every reader of
it then returns None.

A span's "device" time is its CUDA-event interval (`device_ms`), its
"host" time its `perf_counter` interval (`host_ms`).
"""
from __future__ import annotations

from hgsbench.readers import median

ANY = object()


def record(run) -> dict:
    """{"spans": [...], "counters": {...}} of the run (see the program's
    `tracing.snapshot`)."""
    snap = getattr(run, "program_spans", None)
    if snap is None:
        try:
            from horizongs_tpu_torch import tracing
        except ImportError:
            snap = {"spans": [], "counters": {}}
        else:
            snap = tracing.snapshot()
        run.program_spans = snap
    return snap


def median_ms(run, kind: str, name: str, clock: str, parent=ANY):
    """The median `clock` ("device_ms" or "host_ms") of the spans `name`
    (those under the span `parent` where given) in a run of `kind`; None
    where there is none."""
    if run.kind != kind:
        return None
    xs = [sp[clock] for sp in record(run)["spans"]
          if sp["name"] == name and (parent is ANY or sp["parent"] == parent)
          and sp[clock] is not None]
    return median(xs)


def share_pct(run, kind: str, part: str, whole: str):
    """100 x the sum of the counter `part` over that of `whole` in a run
    of `kind`; None where `whole` was not counted."""
    if run.kind != kind:
        return None
    counters = record(run)["counters"]
    total = sum(counters.get(whole, []))
    if not total:
        return None
    return 100.0 * sum(counters.get(part, [])) / total


def visible_pct(run, kind: str):
    """100 x the anchors the LOD mask and the prefilter kept over the rows
    the decode ran over, summed over the decodes of a run of `kind`."""
    return share_pct(run, kind, "render.anchors_visible",
                     "render.anchor_rows")


def fill_pct(run, kind: str):
    """100 x the tile instances over the binning's capacity, summed over
    the renders of a run of `kind`."""
    return share_pct(run, kind, "render.instances", "render.instance_cap")
