"""Force engines (the counterpart of ``nbody_tpu/engines/__init__.py``).

An engine is a named force function ``force(pos, mass_eff, params) -> acc``
where ``mass_eff`` is already zeroed for dead particles.  All engines share
the step loop in ``core/stepper.py``.  A registry entry is an ``Engine`` or a
factory taking build options (``get_engine(name, **options)``), as in the
JAX package.

Every engine of the JAX package is registered.  A stateful engine
(``bh-lazy``, ``bh`` with ``walk_every > 1``) carries a cache between steps
through ``init_carry`` / ``force_carry``, which the stateful stepper
threads (``core/stepper.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

ENGINES: dict = {}


@dataclass(frozen=True)
class Engine:
    name: str
    #: force(pos[N,D], mass_eff[N], params) -> acc[N,D]
    force: Callable
    #: optional: aux(pos, mass_eff, params) -> dict for inspection (the
    #: octree node boxes and walk counters of the bh engines, which the
    #: visualizer draws); None for the brute engines
    aux: Optional[Callable] = None
    description: str = ""
    #: stateful engines carry a cache between steps:
    #: init_carry(pos, mass, params) -> carry and
    #: force_carry(pos, mass, params, carry) -> (acc, carry)
    init_carry: Optional[Callable] = None
    force_carry: Optional[Callable] = None

    @property
    def stateful(self) -> bool:
        return self.force_carry is not None


def register(engine: Engine) -> Engine:
    ENGINES[engine.name] = engine
    return engine


def get_engine(name, **options) -> Engine:
    """Look up an engine by name (an ``Engine`` passes through).  Options
    are bound through the factory registered under the name."""
    if isinstance(name, Engine):
        return name
    try:
        entry = ENGINES[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; available: {sorted(ENGINES)}") from None
    if not isinstance(entry, Engine):
        return entry(**options)
    if options:
        raise TypeError(
            f"engine {name!r} takes no build options (got {sorted(options)})")
    return entry


# Import engine modules for their registration side effects.
from nbody_tpu_torch.engines import brute_force as _bf  # noqa: E402,F401
from nbody_tpu_torch.ops import pairwise as _pw  # noqa: E402,F401  (brute-pallas*)
from nbody_tpu_torch.engines import barnes_hut as _bh  # noqa: E402

ENGINES["bh"] = _bh.bh_factory
ENGINES["bh-deep"] = _bh.bh_deep_factory
ENGINES["bh-lazy"] = _bh.make_bh_lazy_engine
