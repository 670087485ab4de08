"""User-facing ``Simulation`` over the torch core (the counterpart of
``nbody_tpu/api.py``).

    Simulation(pos, vel, mass, engine=..., device="cuda" | "cpu", ...)
    init() / reset()                  snapshot / restore the initial state
    step() / step_by(dt)              one step (negative dt = rewind)
    run(n)                            n steps enqueued without host sync
    compile(n)                        run one step (kernels built) and discard it
    update_forces()                   recompute accelerations in place
    add_point / remove_point / get_points
    n_alive, elapsed, settings / set_settings(**kw), energy(), aux()
    save(path) / load(path)           pickle, same payload as the JAX package

``device="cuda"`` runs on the card or raises; nothing silently runs on the
CPU.  ``engine_options`` bind build options of the ``bh`` engines (a
``profile`` and ``BHConfig`` fields).  ``engine='auto'`` above N = 60000
detects a steep-core scene from its leaf occupancy and routes it to
``profile='adaptive'``; that profile without ``max_level`` /
``refine_levels`` resolves the deep, tight-box or mid-N stack from the
scene, as the JAX package does.  ``compensated=True`` carries a
double-float low word for positions and velocities (``make_step_comp``).
Stateful engines (``bh-lazy``, ``bh`` with ``walk_every > 1``) carry their
tree (and walk topology) between steps (``make_step_stateful``); ``reset``
and ``load`` restore or rebuild that carry.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import torch

from nbody_tpu_torch.core.energy import resolve_energy_method, total_energy
from nbody_tpu_torch.core.state import ParticleState, SimParams, resolve_device
from nbody_tpu_torch.core.stepper import (
    init_comp,
    make_run,
    make_run_comp,
    make_run_stateful,
    make_step,
    make_step_comp,
    make_step_stateful,
)
from nbody_tpu_torch.engines import Engine, get_engine
from nbody_tpu_torch.ops.traversal import (
    STEEP_CONTRAST,
    detect_scene_profile,
    resolve_adaptive_overrides,
    scene_occupancy,
)

# brute/bh crossover kept from the JAX package (measured on a TPU v5e,
# nbody_tpu/api.py:49-59); still to be decided again on the H100
_AUTO_BRUTE_MAX_N = 60000


def resolve_auto_engine(n: int, device) -> str:
    """Engine choice for ``engine="auto"``: direct sum up to N = 60000 (on
    the card through the CUDA kernels), Barnes-Hut above."""
    if n > _AUTO_BRUTE_MAX_N:
        return "bh"
    return "brute" if torch.device(device).type == "cpu" else "brute-pallas"


def _route_engine_options(engine, auto: bool, engine_options, pos,
                          bounds_center, bounds_width) -> dict:
    """The engine options after the JAX package's scene routing
    (``nbody_tpu/api.py:85-129``, with the same printed lines).  ``engine``
    is the resolved engine (a name or an ``Engine``), ``auto`` whether
    ``engine='auto'`` chose it.  An auto-chosen ``bh`` without a profile takes
    ``profile='adaptive'`` and the scene's stack on a steep-core scene;
    ``profile='adaptive'`` on ``bh``/``bh-deep`` without ``max_level`` /
    ``refine_levels`` takes the scene's stack."""
    options = dict(engine_options or {})
    if auto and engine == "bh" and not options.get("profile"):
        occ = scene_occupancy(pos, bounds_center, bounds_width)
        if detect_scene_profile(pos, bounds_center, bounds_width,
                                occupancy=occ) == "adaptive":
            ov = resolve_adaptive_overrides(pos, bounds_center, bounds_width,
                                            occupancy=occ)
            options.update(profile="adaptive", **ov)
            print("[nbody-tpu] engine='auto': steep-core scene detected "
                  f"(occupancy contrast {occ['contrast']:.0f} > "
                  f"{STEEP_CONTRAST:.0f}) -> profile='adaptive' (max_level="
                  f"{ov['max_level']}, refine_levels={ov['refine_levels']}); "
                  "pass engine='bh' or profile='fast' to override")
    if (engine in ("bh", "bh-deep") and options.get("profile") == "adaptive"
            and not any(k in options for k in ("max_level",
                                               "refine_levels"))):
        ov = resolve_adaptive_overrides(pos, bounds_center, bounds_width)
        options.update(ov)
        print("[nbody-tpu] profile='adaptive' resolved to the "
              + ("deep" if ov["max_level"] == 7 else "tight-box")
              + f" stack (max_level={ov['max_level']}, refine_levels="
              f"{ov['refine_levels']}) from the scene's leaf occupancy")
    return options


def _check_format(format: str):
    """The checkpoint formats of the JAX package's ``save``/``load``: the
    pickle is ported; orbax raises."""
    if format == "orbax":
        raise NotImplementedError(
            "format='orbax' is not yet ported to nbody_tpu_torch; "
            "torch.distributed.checkpoint takes its place with the sharded "
            "path (ROADMAP.md, queue 1, item 17)")
    if format != "pickle":
        raise ValueError(
            f"format must be 'pickle' or 'orbax', got {format!r}")


class Simulation:
    def __init__(
        self,
        pos,
        vel,
        mass,
        *,
        engine: str | Engine = "brute",
        integrator: str = "leapfrog",
        bounds_center=(0.0, 0.0, 0.0),
        bounds_width: float = 10.0,
        dtype=torch.float32,
        capacity: Optional[int] = None,
        device="cuda",
        engine_options: Optional[dict] = None,
        compensated: bool = False,
        **settings,
    ):
        """``compensated=True`` carries a double-float low word for pos/vel
        and routes every integrator accumulation through an error-free
        TwoSum (``core/stepper.py`` ``make_step_comp``), which closes most
        of the f32 energy-drift gap to float64."""
        self.device = resolve_device(device)
        auto = engine == "auto"
        if auto:
            engine = resolve_auto_engine(len(mass), self.device)
        engine_options = _route_engine_options(
            engine, auto, engine_options, pos, bounds_center, bounds_width)
        self.engine = get_engine(engine, **(engine_options or {}))
        #: the engine's build options, after the scene routing
        self.engine_options = dict(engine_options or {})
        # capacities match the JAX package's, which pads the kernel engines
        # to a multiple of 2048
        pad_multiple = 2048 if "pallas" in self.engine.name else 128
        self._state = ParticleState.create(
            pos, vel, mass, capacity=capacity, pad_multiple=pad_multiple,
            dtype=dtype, device=self.device,
        )
        self._params = SimParams.create(
            bounds_center=bounds_center,
            bounds_width=bounds_width,
            dtype=dtype,
            device=self.device,
            **settings,
        )
        self.compensated = bool(compensated)
        self._lo = None
        self._carry = None
        if self.engine.stateful:
            if self.compensated:
                raise ValueError(
                    "compensated=True is not supported with stateful engines "
                    "(bh-lazy); use engine='bh'")
            self._carry = self._init_carry()
            self._step = make_step_stateful(self.engine, integrator)
            self._run = make_run_stateful(self.engine, integrator)
        elif self.compensated:
            self._lo = init_comp(self._state)
            self._step = make_step_comp(self.engine.force, integrator)
            self._run = make_run_comp(self.engine.force, integrator)
        else:
            self._step = make_step(self.engine.force, integrator)
            self._run = make_run(self.engine.force, integrator)
        self._initial: Optional[ParticleState] = None
        self.init()

    # -- lifecycle ---------------------------------------------------------

    def init(self):
        """Zero the clock and snapshot the pristine state for ``reset``."""
        self._state = dataclasses.replace(
            self._state, time=torch.zeros_like(self._state.time)
        )
        self._initial = self._state
        self._initial_lo = self._lo
        self._initial_carry = self._carry

    def reset(self):
        """Restore the initial particles (and low words or carry), keep the
        current settings."""
        if self._initial is None:
            raise RuntimeError("init() was never called")
        self._state = self._initial
        self._lo = self._initial_lo
        self._carry = self._initial_carry

    def _init_carry(self):
        """A stateful engine's carry bound to the current state."""
        st = self._state
        return self.engine.init_carry(st.pos, st.effective_mass(),
                                      self._params)

    def _stepper_args(self):
        """The side carry the configured stepper threads: the carry of a
        stateful engine, the low words of a compensated run, else none."""
        if self.engine.stateful:
            return (self._carry,)
        return (self._lo,) if self.compensated else ()

    def _keep(self, out):
        """Store the stepper's output (a state, or a state and its side
        carry)."""
        if self.engine.stateful:
            self._state, self._carry = out
        elif self.compensated:
            self._state, self._lo = out
        else:
            self._state = out

    # -- stepping ----------------------------------------------------------

    def step(self):
        self.step_by(None)

    def step_by(self, dt: Optional[float] = None):
        self._keep(self._step(self._state, *self._stepper_args(),
                              self._params, dt))

    def run(self, n_steps: int, dt: Optional[float] = None):
        """n steps, enqueued without waiting for the device (a stateful
        engine reads one value back a step)."""
        self._keep(self._run(self._state, *self._stepper_args(),
                             self._params, n_steps, dt))
        return self._state

    def compile(self, n_steps: int, dt: Optional[float] = None):
        """Take the one-time costs out of a later timed window, as the JAX
        package's ``compile`` (an ahead-of-time lowering of the fused
        ``run``) does.  Eager torch has no program to lower, so here it
        executes one step of the configured stepper (plain, compensated or
        stateful) on the current state, which builds and loads the kernels
        its engine launches (at their first use) and sizes the allocator's
        caches, then waits for it and throws the result away: the state,
        the low words, a stateful engine's carry (its age included), the
        clock and the ``reset`` target are left as they were (the steppers
        make new tensors and write none in place).  ``n_steps`` is accepted
        for the JAX signature; a step costs the same in every run.
        Returns ``self``."""
        self._step(self._state, *self._stepper_args(), self._params, dt)
        self.block_until_ready()
        return self

    def update_forces(self):
        """Recompute accelerations in place without integrating."""
        st = self._state
        acc = self.engine.force(st.pos, st.effective_mass(), self._params)
        acc = torch.where(st.alive[:, None], acc, torch.zeros_like(acc))
        self._state = dataclasses.replace(st, acc=acc)

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- particles ---------------------------------------------------------

    def add_point(self, pos, vel, mass):
        self._state = self._state.add_point(pos, vel, mass)
        return self

    def remove_point(self, index: int):
        self._state = self._state.remove_point(index)
        return self

    def get_points(self):
        return self._state.get_points()

    @property
    def n_alive(self) -> int:
        return int(self._state.n_alive())

    @property
    def state(self) -> ParticleState:
        return self._state

    @state.setter
    def state(self, s: ParticleState):
        self._state = s

    # -- settings ----------------------------------------------------------

    @property
    def settings(self) -> SimParams:
        return self._params

    def set_settings(self, **kw):
        """Change physics settings live (g, g_soft, dt, theta2, bounds_center,
        bounds_width)."""
        self._params = self._params.replace(**kw)
        return self

    @property
    def elapsed(self) -> float:
        return float(self._state.time)

    # -- diagnostics -------------------------------------------------------

    def energy(self, method: str = "auto") -> float:
        """Total energy: 'exact' (O(N^2) pair PE), 'bh' (the tree
        estimator, ~1e-4 relative bias: fine for one-shot magnitudes, can
        dominate drift measurements at the 1e-5..1e-4 level) or 'auto'
        (exact up to a capacity of 262144, the tree estimator above)."""
        return float(total_energy(self._state, self._params, method=method))

    def energy_method(self, method: str = "auto") -> str:
        """The method 'auto' resolves to at this capacity."""
        return resolve_energy_method(self._state.capacity, method)

    def aux(self) -> dict:
        """Engine-specific inspection data: the bh engines' octree node
        boxes and walk counters; ``{}`` for an engine without ``aux``."""
        if self.engine.aux is None:
            return {}
        st = self._state
        return self.engine.aux(st.pos, st.effective_mass(), self._params)

    # -- checkpointing: the JAX package's pickle payload, both ways --------

    def _payload(self) -> dict:
        out = {
            "state": self._state.to_numpy(),
            "params": self._params.to_numpy(),
            "engine": self.engine.name,
        }
        if self.compensated:
            # the low words ride along so a restored run keeps its
            # compensation
            out["lo"] = {"pos_lo": self._lo[0].cpu().numpy(),
                         "vel_lo": self._lo[1].cpu().numpy()}
        return out

    def save(self, path: str, format: str = "pickle"):
        """Write a pickle that this package's and the JAX package's
        ``Simulation.load`` both read.  ``format='orbax'`` (the JAX
        package's sharded checkpoints) is not ported."""
        _check_format(format)
        with open(path, "wb") as f:
            pickle.dump(self._payload(), f)

    def load(self, path: str, format: str = "pickle"):
        """Read a pickle written by ``save`` of either package.  The low
        words of a compensated checkpoint are restored in a compensated
        ``Simulation`` (zeros when the file has none) and ignored in a
        plain one.  A stateful engine's carry is rebuilt from the restored
        state.  The restored point becomes the ``reset`` target."""
        _check_format(format)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._state = ParticleState.from_numpy(payload["state"], self.device)
        self._params = SimParams.from_numpy(payload["params"], self.device)
        if self.compensated:
            lo = payload.get("lo")
            self._lo = (init_comp(self._state) if lo is None else tuple(
                torch.as_tensor(lo[k], device=self.device)
                for k in ("pos_lo", "vel_lo")))
        if self.engine.stateful:
            # the carried tree is bound to the positions it was built from
            self._carry = self._init_carry()
        self._initial = self._state
        self._initial_lo = self._lo
        self._initial_carry = self._carry
        return self
