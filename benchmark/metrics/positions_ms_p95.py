"""positions_ms_p95 (host clock): the 95th percentile over
every ``/api/positions`` request the viewer sent in the window, from the
request's send to its reply's last byte.  A request that failed counts as
having waited the whole window."""

import numpy as np

ROUTE = "/api/positions"


def read(run):
    lat = run.window.get("latency_ms", {}).get(ROUTE)
    if not lat:
        return None
    failed = [f for f in run.window.get("failures", [])
              if f.startswith(ROUTE)]
    lat = list(lat) + [run.window["seconds"] * 1e3] * len(failed)
    return float(np.percentile(lat, 95))
