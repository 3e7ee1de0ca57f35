"""Share of the traced stretch's image frames that the viewer quantized on
the card (counters `viewer.frames_on_card` over
`viewer.frames_quantized`), in %; None where the program counts neither."""
from hgsbench.spans import share_pct


def read(run):
    return share_pct(run, "view", "viewer.frames_on_card",
                     "viewer.frames_quantized")
