"""The training views' SH colour evaluation's share of its roofline: the
least time of the rows each span `render.sh` inside `render.bin`
evaluated (`hgsbench/counts_sh.py`, from that evaluation's counters
`render.sh_rows` and `render.sh_coeffs`) over the spans' device ms
(CUDA events), summed over the traced stretch, in %. None without such
a span (RGB colours), or where the counters do not pair with the
spans."""
from hgsbench import counts, counts_sh
from hgsbench.spans import record


def read(run):
    if run.kind != "train":
        return None
    rec = record(run)
    evals = [sp for sp in rec["spans"] if sp["name"] == "render.sh"]
    rows = rec["counters"].get("render.sh_rows", [])
    coeffs = rec["counters"].get("render.sh_coeffs", [])
    if not evals or not len(evals) == len(rows) == len(coeffs):
        return None
    kept = [(sp["device_ms"], r, c) for sp, r, c in zip(evals, rows, coeffs)
            if sp["parent"] == "render.bin" and sp["device_ms"] is not None]
    if not kept:
        return None
    least = sum(counts_sh.least_seconds(r, c) for _, r, c in kept)
    return counts.percent(least, sum(ms for ms, _, _ in kept) / 1e3)
