"""Share of the traced stretch of serving with no operation on the
device (the union of its operations' intervals over every stream)."""
from hgsbench.readers import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "view" else None
