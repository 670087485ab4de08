"""Initial-condition generators (numpy, float64, seeded with ``default_rng``).

These are copies of ``nbody_tpu/scenes``, not imports of it: importing
``nbody_tpu.scenes`` runs ``nbody_tpu/__init__.py``, which imports jax, and
the port never imports jax.  ``tests/test_torch_scenes.py`` holds every scene
bit-equal to the JAX package's."""

from nbody_tpu_torch.scenes.disc import self_gravitating_disc
from nbody_tpu_torch.scenes.extras import (disc_2d, disc_bulge,
                                           hernquist_sphere, plummer_sphere,
                                           uniform_cube)

SCENES = {
    "disc": self_gravitating_disc,
    "plummer": plummer_sphere,
    "cube": uniform_cube,
    "hernquist": hernquist_sphere,
    "disc-bulge": disc_bulge,
}

__all__ = ["self_gravitating_disc", "plummer_sphere", "uniform_cube",
           "hernquist_sphere", "disc_bulge", "disc_2d", "SCENES"]
