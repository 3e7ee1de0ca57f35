"""Median host ms of a step build's capacity calibration, the span
`trainer.calibrate`; None where the traced stretch built no step (it
held no densify epoch)."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "trainer.calibrate", "host_ms")
