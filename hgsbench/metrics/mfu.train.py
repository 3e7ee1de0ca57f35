"""The kept training steps' needed FP32 operations (decoders forward and
backward over the anchors the view selects, plus the compositors'
counted work) over their count x the median step ms outside the
profiler's stretch x 67 TFLOP/s, in %."""
from hgsbench import counts
from hgsbench.readers import CALL_KIND, median, untraced


def read(run):
    calls = run.out.get("calls", [])
    if run.kind != "train" or run.trace is None or not calls:
        return None
    rec = run.out["records"]
    step_s = median([rec["step_ms"][i] for i in untraced(run)]) / 1e3
    flops = 0.0
    for c in calls:
        ks = [k for k, kind in CALL_KIND.items() if kind == c["kind"]]
        flops += counts.step_flops(run.model, c["visible"],
                                   {k: c["pairs"] for k in ks}, train=True)
    return counts.percent(flops, len(calls) * step_s * counts.FP32_FLOPS)
