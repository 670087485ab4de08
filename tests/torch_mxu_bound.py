"""The JAX package's norm-trick kernel (``pairwise_acc_pallas_mxu``, K6) on
the input of the port's ``brute-pallas-mxu`` check in ``chip_smoke.py``:
its own force error there is the yardstick that check holds the port's
kernel to.

    python tests/torch_mxu_bound.py [N [STEPS]]   # default 65535 25

The disc of the CLI (seed 0, N + the star, capacity a multiple of 2048),
as it starts and after STEPS leapfrog steps of dt 3e-2 (the JAX package's
``brute`` engine; the check on the card runs as many through K6, whose
positions differ from these by f32 rounding only), is Morton-sorted as the
engine sorts it, run through the Pallas kernel in interpret mode on the CPU
(the tile grid 512 x 1024 of the engine), and scattered back.  Printed for
each state: the error of 1024 sampled alive rows (the rows
``chip_smoke.py`` samples) against a float64 direct sum, as the max-row
|da| over the mean-row |a| and as the median and p99 of |da| / max(|a|,
median |a|).  Takes some 30 minutes at the default size.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from nbody_tpu.ops import morton  # noqa: E402
from nbody_tpu.ops.pairwise import pairwise_acc_pallas_mxu  # noqa: E402
from nbody_tpu.ops.tree import grid_bounds  # noqa: E402
from nbody_tpu.scenes import self_gravitating_disc  # noqa: E402

G, EPS = 1.0, 0.02


def errors(got, truth):
    """(max-row |d| / mean-row |truth|, median and p99 of the row error
    |d| / max(|truth|, median |truth|))."""
    tn = np.linalg.norm(truth, axis=1)
    d = np.linalg.norm(got - truth, axis=1)
    row = d / np.maximum(tn, np.median(tn))
    return (float(d.max() / tn.mean()), float(np.median(row)),
            float(np.percentile(row, 99)))


def kernel_error(st, params):
    """The JAX engine's K6 path on ``st`` against a float64 direct sum on
    1024 sampled alive rows."""
    m = st.effective_mass()
    codes = morton.cell_codes(st.pos, grid_bounds(params.bounds, 10), 10)
    order = jnp.argsort(jnp.where(m > 0, codes, jnp.int32(1 << 30)))
    acc_s = pairwise_acc_pallas_mxu(st.pos[order], m[order], G, EPS,
                                    interpret=True)
    acc = np.asarray(jnp.zeros_like(acc_s).at[order].set(acc_s))

    alive = np.nonzero(np.asarray(st.alive))[0]
    rows = np.random.default_rng(0).choice(alive, 1024, replace=False)
    p = np.asarray(st.pos, np.float64)
    mm = np.asarray(m, np.float64)
    truth = np.zeros((len(rows), 3))
    for s in range(0, len(rows), 64):
        d = p[None, :, :] - p[rows[s:s + 64], None, :]
        r2 = (d * d).sum(-1) + np.float64(np.float32(EPS)) ** 2
        truth[s:s + 64] = G * ((mm / r2 ** 1.5)[..., None] * d).sum(1)
    return errors(acc[rows].astype(np.float64), truth)


def main(n=65535, steps=25):
    from nbody_tpu.api import Simulation

    pos, vel, mass = self_gravitating_disc(n, seed=0)
    sim = Simulation(pos, vel, mass, engine="brute", dtype=jnp.float32,
                     dt=3e-2, g_soft=EPS)
    done = 0
    for k in sorted({0, steps}):
        if k > done:
            sim.run(k - done)
            done = k
        st = sim.state
        e_max, e_med, e_p99 = kernel_error(st, sim.settings)
        print(f"JAX pairwise_acc_pallas_mxu (interpret, CPU), disc {n} + "
              f"star, capacity {st.capacity}, after {k} steps: 1024 sampled "
              f"alive rows vs float64 direct sum: max-row/mean-row "
              f"{e_max:.4e}, row error median {e_med:.4e}, p99 {e_p99:.4e}",
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
