"""The kept frames' needed FP32 operations (decoders and their SH
colours forward over the anchors the view selects, plus K1's counted
work) over their count x the median render time (the span around
render_request) x 67 TFLOP/s, in %."""
from hgsbench import counts
from hgsbench.readers import median


def read(run):
    calls = run.out.get("calls", [])
    if run.kind != "view" or run.trace is None or not calls:
        return None
    render_s = median(run.out["spans"]["render_ms"]) / 1e3
    flops = sum(counts.step_flops(run.model, c["visible"],
                                  {"k1": c["pairs"]}, train=False)
                for c in calls)
    return counts.percent(flops, len(calls) * render_s * counts.FP32_FLOPS)
