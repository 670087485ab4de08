"""Scene ``disc``: the benchmark's own copy of rebound's
self-gravitating disc (nbody-llm ``src/main.rs:52-89``, rebound
``reference/main.c:41-61``), as ``nbody_tpu_torch/scenes/disc.py`` builds
it.  It is frozen here so that a change to the program cannot change the
inputs it is measured on; ``benchmark/tests/test_bench_frozen.py`` holds it
bit-equal to the program's copy.

A central star of mass 1 at the origin plus ``n`` disc particles:

  * semi-major axis from a power law over [box/10, box/2/1.2]:
        a = ((amax^-1/2 - amin^-1/2) * u + amin^-1/2)^-2
  * uniform azimuth; z = a * u * 1e-3 - 5e-4
  * circular Keplerian speed from the enclosed-mass proxy
        mu = 1 + disc_mass * (a^-3/2 - amin^-3/2) / (amax^-3/2 - amin^-3/2)
  * mass disc_mass / n each.

Generated in float64 on the host from ``numpy.random.default_rng(seed)``.
A configuration names a scene by this file's name (``"scene": "disc"``);
its parameters are the configuration's ``disc`` group.
"""

from __future__ import annotations

import numpy as np


def self_gravitating_disc(n: int, *, box_width: float = 10.0,
                          disc_mass: float = 0.2, star_mass: float = 1.0,
                          seed: int = 0):
    """(pos [n+1, 3], vel [n+1, 3], mass [n+1]) float64; row 0 is the
    star."""
    rng = np.random.default_rng(seed)
    amax = box_width / 2.0 / 1.2
    amin = box_width / 10.0

    u_a = rng.random(n)
    a = ((amax ** -0.5 - amin ** -0.5) * u_a + amin ** -0.5) ** -2.0
    phi = rng.random(n) * 2.0 * np.pi
    x = a * np.cos(phi)
    y = a * np.sin(phi)
    z = a * rng.random(n) * 0.001 - 0.0005
    mu = 1.0 + disc_mass * (a ** -1.5 - amin ** -1.5) / (amax ** -1.5
                                                         - amin ** -1.5)
    vkep = np.sqrt(mu / a)
    vx = vkep * np.sin(phi)
    vy = -vkep * np.cos(phi)
    vz = np.zeros(n)

    pos = np.concatenate([np.zeros((1, 3)), np.stack([x, y, z], axis=-1)])
    vel = np.concatenate([np.zeros((1, 3)), np.stack([vx, vy, vz], axis=-1)])
    mass = np.concatenate([[star_mass], np.full(n, disc_mass / n)])
    return pos, vel, mass


make = self_gravitating_disc
