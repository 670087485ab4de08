"""Force engines (the counterpart of ``nbody_tpu/engines/__init__.py``).

An engine is a named force function ``force(pos, mass_eff, params) -> acc``
where ``mass_eff`` is already zeroed for dead particles.  All engines share
the step loop in ``core/stepper.py``.  A registry entry is an ``Engine`` or a
factory taking build options (``get_engine(name, **options)``), as in the
JAX package.

Only engines whose every part is ported are registered, so the registry
never lists an engine that does not exist.  The JAX package's other engine
names raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

ENGINES: dict = {}

NOT_YET_PORTED = {
    "bh-lazy": "the off-main-path BH variants (ROADMAP.md, queue 1, item 16)",
}


@dataclass(frozen=True)
class Engine:
    name: str
    #: force(pos[N,D], mass_eff[N], params) -> acc[N,D]
    force: Callable
    description: str = ""
    #: carries a cache between steps (``bh-lazy`` in the JAX package); the
    #: stateful stepper is not ported yet (ROADMAP.md, queue 1, item 16)
    stateful: bool = False


def register(engine: Engine) -> Engine:
    ENGINES[engine.name] = engine
    return engine


def get_engine(name, **options) -> Engine:
    """Look up an engine by name (an ``Engine`` passes through).  Options
    are bound through the factory registered under the name."""
    if isinstance(name, Engine):
        return name
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not yet ported to nbody_tpu_torch; it comes "
            f"with {NOT_YET_PORTED[name]}"
        )
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
