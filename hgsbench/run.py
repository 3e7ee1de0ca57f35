"""Run one benchmark cell once and print its result line.

    python -m hgsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root:
the cell's configuration file, its traffic file under
`hgsbench/traffic/<traffic>.json` (whose `kind` names the driver,
`hgsbench/<kind>.py`), its limits under `hgsbench/limits/<cell>.json` and
each per-layer metric's reader under `hgsbench/metrics/<metric>.py`. A
cell, a configuration, a traffic mix of an existing kind or a per-layer
metric is added by adding files and entries. A driver's `run(ctx)` gets
the cell's chip count as `ctx.chips`; a driver for several chips
launches its own ranks and returns rank 0's output, with the cards it
used as `count`.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics, or with
`--trace 1` the per-layer ones), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each compared number with its limit; the
same numbers are the last lines of standard error. Without a card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed (in this process, or in a rank a driver
started: the driver reports what each had loaded as `forbidden`), it
prints no result and exits non-zero.
Standard error also carries the readings that are not compared (the
program's and the reference's, each leaf's), as one `detail` line.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "horizongs_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(man: dict, cell_name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell's entry, configuration (its file: `yaml`, `scene` and the
    model's kwargs as `model`), traffic, limits and metric entries, found
    by name."""
    cells = {w["name"]: w for w in man["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    cfg["model"] = cfg["yaml"]["model_params"]["model_config"]["kwargs"]
    with open(root / "hgsbench" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    lim_path = root / "hgsbench" / "limits" / f"{cell_name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}

    def applies(m):
        return cell_name in m.get("workloads", [w["name"] for w in
                                                man["workloads"]])
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, limits=limits,
        end_to_end=[m for m in man["end_to_end"] if applies(m)],
        per_layer=[m for m in man["per_layer"] if applies(m)])


def reader(name: str, root: Path = ROOT):
    """`read(run)` of the per-layer metric `name`."""
    spec = importlib.util.spec_from_file_location(
        f"hgsbench_metric_{name.replace('.', '_').replace('-', '_')}",
        root / "hgsbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number the cell's limits name, beside its
    limit. A cell without limits, a named number the run did not read, or
    one above its limit or not finite, is not correct; the other readings
    are shown in the run's detail, not compared."""
    checks, ok = {}, bool(limits)
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        checks[k] = {"value": v, "limit": lim}
        if not math.isfinite(v) or v > lim:
            ok = False
    return ok, checks


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def measure(spec: SimpleNamespace, seed: int, seconds: float, trace: bool,
            device, t0: float = T0) -> dict:
    """Drive the cell once on `device` and assemble its result (without
    the chip checks of `main`)."""
    import torch
    from hgsbench import trace as trace_mod
    torch.set_num_threads(min(4, torch.get_num_threads()))
    driver = importlib.import_module(f"hgsbench.{spec.traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="hgsbench-") as tmp:
        ctx = SimpleNamespace(cfg=spec.cfg, traffic=spec.traffic, seed=seed,
                              seconds=seconds, trace=trace, device=device,
                              chips=int(spec.cell.get("chips", 1)),
                              t0=t0, tmpdir=tmp, root=str(ROOT))
        out = driver.run(ctx)
        tr = (trace_mod.read(out["trace_path"])
              if trace and out.get("trace_path") else None)
    correct, checks = judge(out["numbers"], spec.limits)
    correct = correct and out["failed"] == 0
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": out.get("count", 1),
                "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if not trace:
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
        result = {"correct": correct, "attempted": out["attempted"],
                  "failed": out["failed"], "metrics": metrics,
                  "device": dev_info}
    else:
        run = SimpleNamespace(
            cell=spec.cell["name"], kind=spec.traffic["kind"],
            model=spec.cfg["model"], out=out, trace=tr,
            program_spans=out.get("program_spans"),
            sfu_rate=(None if device.type != "cuda" else
                      16 * torch.cuda.get_device_properties(device)
                      .multi_processor_count * sm_clock_hz()))
        for m in spec.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result = {"correct": correct, "attempted": out["attempted"],
                  "failed": out["failed"], "metrics": metrics,
                  "device": dev_info}
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.device_ops,
                                   "idle_gaps": tr.idle_gaps}
    # what a driver's own processes (a mesh's ranks) had loaded
    result["_forbidden"] = out.get("forbidden", [])
    result["stages"] = out.get("stages", {})
    result["checks"] = checks
    result["_detail"] = {k: v for k, v in out["numbers"].items()
                         if k not in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(load_manifest(), args.workload)

    import torch
    chips = int(spec.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hgsbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    result = measure(spec, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    bad = sorted(set(forbidden_modules()).union(result.pop("_forbidden")))
    if bad:
        print(f"hgsbench: loaded in this process or a rank's: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    detail = result.pop("_detail")
    print(f"detail {json.dumps(detail, default=str)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
