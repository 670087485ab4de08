"""The viewer of traffic kind ``view`` (``drivers/view.py``), in a process
of its own, as the repository's browser client is
(``vis/static/index.html``): one closed loop a route, each asking again
``gap_ms`` after each reply.

    python3 benchmark/harness/viewer.py <port> '<{route: gap_ms}>'

Reads the window's length in seconds as one line on standard input, polls
``127.0.0.1:<port>`` until it has passed, waits for the last replies, and
prints one JSON object: every reply's latency by route in ms (send to last
byte) and the requests that failed.  Imports nothing but the standard
library.
"""

import http.client
import json
import sys
import threading
import time


def get(port: int, path: str) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"GET {path}: HTTP {resp.status}")
        return data
    finally:
        conn.close()


def main(port: int, pollers: dict, seconds: float) -> dict:
    lat = {route: [] for route in pollers}
    failures = []
    end = time.perf_counter() + seconds

    def poll(route, gap_s):
        while time.perf_counter() < end:
            t = time.perf_counter()
            try:
                get(port, route)
            except (OSError, http.client.HTTPException,
                    RuntimeError) as e:  # counted as failed
                failures.append(f"{route}: {e!r}")
            else:
                lat[route].append((time.perf_counter() - t) * 1e3)
            time.sleep(gap_s)

    threads = [threading.Thread(target=poll, args=(r, g / 1e3))
               for r, g in pollers.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return {"latency_ms": lat, "failures": failures}


if __name__ == "__main__":
    port, pollers = int(sys.argv[1]), json.loads(sys.argv[2])
    seconds = float(sys.stdin.readline())
    print(json.dumps(main(port, pollers, seconds)), flush=True)
