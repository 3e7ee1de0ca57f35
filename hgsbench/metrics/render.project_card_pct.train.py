"""Share of the rows the traced stretch projected that went through P1 on
the card (counters `render.project_rows_card` over
`render.project_rows`), in %: 100 where every 3DGS projection runs the
kernels, 0 for surfels, whose projection is plain PyTorch; None where the
program counts neither."""
from hgsbench.spans import share_pct


def read(run):
    return share_pct(run, "train", "render.project_rows_card",
                     "render.project_rows")
