"""Share of the binning's sorted slots that a frame's tile instances fill
(counters `render.instances` over `render.instance_cap`, summed over the
traced frames), in %: every binning pass and the sort run over the
calibrated capacity, so the rest is padding."""
from hgsbench.spans import fill_pct


def read(run):
    return fill_pct(run, "view")
