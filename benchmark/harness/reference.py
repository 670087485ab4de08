"""The plain reference of one step of the simulation, in plain PyTorch: no
import of the program, and nothing the program made but the states it is
asked to judge.

One step of the program (``nbody_tpu_torch/core/stepper.py``, the
reference's ``step_by``) is, for every row that is alive:

    1. half drift        x_h = x + v * dt/2            (in the state's dtype)
    2. open-box cull     alive' = alive and x_h inside the box (faces in)
    3. force             a = G sum_j m_j (x_j - x_h) / (|x_j - x_h|^2 + eps^2)^3/2
                         over the rows alive after the cull
    4. kick, half drift  v' = v + a dt,  x' = x_h + v' dt/2

and a row that is dead (or dies in step 2) keeps its position (the drifted
one, if it dies now) and its velocity, with a = 0.

``step_check`` holds a program's step, the state before it and the state
it gave, against this: the cull row by row, the integrator on every row
(from the program's own force, in float64), and the force on rows drawn
from the seed against the exact sum (``direct_accel``, float64).  The
Barnes-Hut force differs from the exact sum by its own approximation
(theta^2 = 1), so the force is judged by statistics of the relative error
whose limits ``PERF.md`` derives from measured readings.
"""

from __future__ import annotations

import numpy as np
import torch


def half_drift(pos, vel, dt):
    """Step 1 in the dtype of ``pos`` (the same operations as the
    program's leapfrog, so the same bits)."""
    return pos + vel * (dt * 0.5)


def inside(pos, center, width):
    """Step 2's test, faces included, in the dtype of ``pos``."""
    c = torch.as_tensor(center, dtype=pos.dtype, device=pos.device)
    half = torch.as_tensor(width, dtype=pos.dtype, device=pos.device) * 0.5
    return ((pos >= c - half) & (pos <= c + half)).all(dim=-1)


#: the most that ``direct_accel``'s temporaries take at once
SUM_BUDGET = 4 << 30
#: values a (target, source) pair holds at once in ``direct_accel``: the
#: offset ``d`` (3), its square (3) and their sum (1) at the most in the
#: second line, and a copy of ``d`` (3) should the contraction make one
PAIR_VALUES = 10
#: the targets a pass takes where the budget allows it
MOST_TARGETS = 64


def sum_chunk(n_src: int, itemsize: int, budget: int = SUM_BUDGET) -> int:
    """The targets ``direct_accel`` takes a pass over ``n_src`` sources of
    ``itemsize`` bytes: ``MOST_TARGETS``, or fewer where their
    temporaries (``sum_bytes``) would pass ``budget``; at least 1."""
    fit = budget // (PAIR_VALUES * itemsize * max(1, n_src))
    return max(1, min(MOST_TARGETS, fit))


def sum_bytes(chunk: int, n_src: int, itemsize: int) -> int:
    """The bytes ``direct_accel``'s temporaries take at once for
    ``chunk`` targets."""
    return PAIR_VALUES * itemsize * chunk * n_src


def direct_accel(tgt, src, mass, g, eps, budget=SUM_BUDGET):
    """The exact softened sum of step 3 at the targets ``tgt`` [K, 3] over
    the sources ``src`` [N, 3] with masses ``mass`` [N] (zero for a dead
    row), computed in the dtype of the inputs, ``sum_chunk`` targets a
    pass: 64 where their temporaries stay under ``budget`` bytes (4 GiB
    by default, which holds 64 up to N = 838860 in float64), fewer above,
    down to one target a pass over the sources.  A target's sum is the
    same whatever the chunk."""
    chunk = sum_chunk(src.shape[0], src.element_size(), budget)
    eps2 = torch.as_tensor(eps, dtype=src.dtype, device=src.device) ** 2
    out = torch.empty_like(tgt)
    for i in range(0, tgt.shape[0], chunk):
        d = src[None, :, :] - tgt[i:i + chunk, None, :]       # [c, N, 3]
        r2 = (d * d).sum(-1) + eps2                           # [c, N]
        w = mass[None, :] * torch.rsqrt(r2) ** 3
        out[i:i + chunk] = g * torch.einsum("cn,cnk->ck", w, d)
    return out


def force_errors(acc, ref):
    """Per-row relative error of ``acc`` against ``ref`` (both [K, 3]):
    ``|acc - ref| / max(|ref|, median |ref|)``, the repository's measure of
    a Barnes-Hut force (``tests/test_barnes_hut.py``)."""
    rn = ref.norm(dim=1)
    return (acc - ref).norm(dim=1) / torch.clamp(rn, min=float(rn.median()))


def sample_rows(alive: np.ndarray, k: int, seed: int, salt: int):
    """``k`` alive row indices (sorted) drawn from ``seed``; ``salt`` keeps
    the draws of two checks in one run apart."""
    idx = np.nonzero(alive)[0]
    rng = np.random.default_rng([seed, salt])
    return np.sort(rng.choice(idx, size=min(k, len(idx)), replace=False))


def _ratio(x: float, scale: float) -> float:
    if scale > 0:
        return x / scale
    return 0.0 if x == 0 else float("inf")


def step_check(before: dict, after: dict, phys: dict, rows) -> dict:
    """The numbers of one step: ``before`` holds the state the step began
    from (``pos``, ``vel``, ``mass``, ``alive``), ``after`` the state it
    gave (``pos``, ``vel``, ``acc``, ``alive``), ``phys`` the settings
    (``g``, ``eps``, ``dt``, ``center``, ``width``) and ``rows`` the sampled
    rows (a device index tensor).  The force's reference is the exact sum
    in float64."""
    pos, vel, alive = before["pos"], before["vel"], before["alive"]
    dt32 = float(np.float32(phys["dt"]))
    x_h = torch.where(alive[:, None], half_drift(pos, vel, dt32), pos)
    alive_ref = alive & inside(x_h, phys["center"], phys["width"])
    out = {"alive_mismatch": int((alive_ref != after["alive"]).sum())}

    # the integrator, from the program's own force, in float64
    a64 = after["acc"].double()
    xh64, v64 = x_h.double(), vel.double()
    col = alive_ref[:, None]
    v_ref = torch.where(col, v64 + a64 * phys["dt"], v64)
    x_ref = torch.where(col, xh64 + v_ref * (phys["dt"] * 0.5), xh64)
    dead_acc = float(a64[~alive_ref].abs().max()) if bool(
        (~alive_ref).any()) else 0.0
    out["state_err"] = max(
        _ratio(float((after["pos"].double() - x_ref).abs().max()),
               0.5 * phys["width"]),
        _ratio(float((after["vel"].double() - v_ref).abs().max()),
               float(v_ref.abs().max())),
        _ratio(dead_acc, float(a64.abs().max())))

    # the force at the sampled rows against the exact sum
    m = torch.where(alive_ref, before["mass"], torch.zeros_like(
        before["mass"])).double()
    src = x_h.double()
    ref = direct_accel(src[rows], src, m, phys["g"], phys["eps"])
    out["force_e"] = force_errors(after["acc"][rows].double(), ref)
    return out


def control_step(before: dict, acc_fill, phys: dict, rows,
                 dtype=torch.bfloat16) -> dict:
    """The reference put in the program's place and computed in ``dtype``
    (bfloat16: the precision below the configuration's float32): one step
    from ``before`` with every operation in ``dtype``, returned in
    ``before``'s dtype as ``step_check`` takes it.  Its force is the exact
    sum in ``dtype`` at the sampled ``rows``; the other rows, which only
    the integrator's numbers read, take ``acc_fill`` rounded to ``dtype``
    (an exact sum over every row would take minutes)."""
    f = before["pos"].dtype
    pos, vel = before["pos"].to(dtype), before["vel"].to(dtype)
    alive = before["alive"]
    x_h = torch.where(alive[:, None], half_drift(pos, vel, phys["dt"]), pos)
    alive2 = alive & inside(x_h, phys["center"], phys["width"])
    m = torch.where(alive2, before["mass"],
                    torch.zeros_like(before["mass"])).to(dtype)
    acc = acc_fill.to(dtype).clone()
    acc[rows] = direct_accel(x_h[rows], x_h, m, phys["g"], phys["eps"])
    acc = torch.where(alive2[:, None], acc, torch.zeros_like(acc))
    col = alive2[:, None]
    v2 = torch.where(col, vel + acc * phys["dt"], vel)
    x2 = torch.where(col, x_h + v2 * (phys["dt"] * 0.5), x_h)
    return {"pos": x2.to(f), "vel": v2.to(f), "acc": acc.to(f),
            "alive": alive2}
