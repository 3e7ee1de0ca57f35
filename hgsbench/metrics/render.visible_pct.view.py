"""Share of the rows a frame's decode runs over that the LOD mask and
the prefilter keep (counters `render.anchors_visible` over
`render.anchor_rows`, summed over the traced frames' decodes, a
calibration's among them), in %."""
from hgsbench.spans import visible_pct


def read(run):
    return visible_pct(run, "view")
