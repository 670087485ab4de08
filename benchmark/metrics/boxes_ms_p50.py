"""boxes_ms_p50 (host clock): the median ``/api/boxes`` reply in the
window (an octree build and a walk on the card, ``Simulation.aux``), send
to last byte."""

import numpy as np


def read(run):
    lat = run.window.get("latency_ms", {}).get("/api/boxes")
    if not lat:
        return None
    return float(np.median(lat))
