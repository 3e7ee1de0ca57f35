"""MB the collectives carry in one training step: the bytes of every
collective's input, as the program's `parallel.collectives.STATS` counts
them over one step taken after the window."""


def read(run):
    ops = run.out.get("collectives")
    if not ops:
        return None
    return sum(op["bytes"] for op in ops.values()) / 1e6
