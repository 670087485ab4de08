"""The comparison that decides ``correct``.

The window's output is the state it ended at.  A Barnes-Hut trajectory
cannot be recomputed independently (the force is approximate, and the
orbits amplify any difference), so the check follows the program one step
at a time from its own state, twice: the first step of the run, from the
scene the benchmark made, and one step through the window's own call once
the window has closed, from the state the window ended at
(``reference.step_check``).  The steps between are held to what the
window's end state must show by itself: every real row that is dead lies
outside the box (a row dies only by leaving it, and then stays where it
left).  In ``view`` the positions payload the server sends once the window
has closed is compared byte for byte with the rows it must hold.

Each number has a limit of its own in the configuration's ``check``
(``PERF.md`` gives the readings each was set from); the exact ones have 0.
"""

from __future__ import annotations

import math

import numpy as np

from harness import reference


def stats(step: dict) -> dict:
    """Every number of one ``reference.step_check`` output; a
    configuration's ``check`` picks which it compares."""
    out = {"alive_mismatch": step["alive_mismatch"],
           "state_err": step["state_err"]}
    e = step["force_e"].cpu().numpy()
    for q in (10, 25, 50, 75, 90, 99):
        out[f"force_e_p{q}"] = float(np.percentile(e, q))
    return out


def combine(steps: list) -> dict:
    """The numbers of several checked steps: counts add, the rest take
    the worst step."""
    out = {}
    for s in steps:
        for k, v in s.items():
            if k == "alive_mismatch":
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, -math.inf), v)
    return out


def dead_inside(pos, alive, n_real: int, phys: dict) -> int:
    """Real rows (index < ``n_real``) that are dead but inside the box."""
    ins = reference.inside(pos[:n_real], phys["center"], phys["width"])
    return int((ins & ~alive[:n_real]).sum())


def expected_payload(pos, alive, max_points: int) -> bytes:
    """The ``/api/positions`` body a state must give: the rows at the
    capacity-based stride, alive ones only, float32 xyz."""
    cap = pos.shape[0]
    stride = 1 if max_points <= 0 else max(1, -(-cap // max_points))
    p = pos[::stride][alive[::stride]]
    return np.ascontiguousarray(p.cpu().numpy(), dtype=np.float32).tobytes()


def payload_mismatch(got: bytes, want: bytes) -> int:
    """float32 values that differ, plus any in one body only."""
    a = np.frombuffer(got[:len(got) // 4 * 4], dtype=np.uint32)
    b = np.frombuffer(want, dtype=np.uint32)
    n = min(len(a), len(b))
    return int((a[:n] != b[:n]).sum()) + abs(len(a) - len(b)) + len(got) % 4


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name; a number the run did not produce, or one that is not finite,
    fails."""
    table, ok = {}, True
    for name in sorted(limits):
        v = numbers.get(name)
        lim = limits[name]
        good = v is not None and math.isfinite(v) and v <= lim
        ok &= good
        table[name] = {"value": v, "limit": lim}
    return ok, table
