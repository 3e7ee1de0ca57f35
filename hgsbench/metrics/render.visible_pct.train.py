"""Share of the rows a training view's decode runs over that the LOD
mask and the prefilter keep (counters `render.anchors_visible` over
`render.anchor_rows`, summed over the traced stretch's decodes: the steps', and those of
a calibration where the stretch builds a step), in %."""
from hgsbench.spans import visible_pct


def read(run):
    return visible_pct(run, "train")
