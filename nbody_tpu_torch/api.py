"""User-facing ``Simulation`` over the torch core (the counterpart of
``nbody_tpu/api.py``).

    Simulation(pos, vel, mass, engine=..., device="cuda" | "cpu", ...)
    init() / reset()                  snapshot / restore the initial state
    step() / step_by(dt)              one step (negative dt = rewind)
    run(n)                            n steps enqueued without host sync
    update_forces()                   recompute accelerations in place
    add_point / remove_point / get_points
    n_alive, elapsed, settings / set_settings(**kw), energy()
    save(path) / load(path)           pickle, same payload as the JAX package

``device="cuda"`` runs on the card or raises; nothing silently runs on the
CPU.  ``engine_options`` bind build options of the ``bh`` engines (a
``profile`` and ``BHConfig`` fields).  ``engine='auto'`` above N = 60000
detects a steep-core scene from its leaf occupancy and routes it to
``profile='adaptive'``; that profile without ``max_level`` /
``refine_levels`` resolves the deep, tight-box or mid-N stack from the
scene, as the JAX package does.  ``compensated=True`` carries a
double-float low word for positions and velocities (``make_step_comp``).
Not yet ported (they raise): stateful engines.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Optional

import torch

from nbody_tpu_torch.core.energy import resolve_energy_method, total_energy
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.core.stepper import (
    init_comp,
    make_run,
    make_run_comp,
    make_step,
    make_step_comp,
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


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and there is none."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but CUDA is not available; pass "
            "device='cpu' to run the plain torch path on the CPU"
        )
    return device


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
        if self.engine.stateful:
            if compensated:
                raise ValueError(
                    "compensated=True is not supported with stateful engines "
                    "(bh-lazy); use engine='bh'")
            raise NotImplementedError(
                "stateful engines (the stateful stepper) are not yet ported "
                "to nbody_tpu_torch (ROADMAP.md, queue 1, item 16)")
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
        if self.compensated:
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

    def reset(self):
        """Restore the initial particles (and low words), keep the current
        settings."""
        if self._initial is None:
            raise RuntimeError("init() was never called")
        self._state = self._initial
        self._lo = self._initial_lo

    # -- stepping ----------------------------------------------------------

    def step(self):
        self.step_by(None)

    def step_by(self, dt: Optional[float] = None):
        if self.compensated:
            self._state, self._lo = self._step(self._state, self._lo,
                                               self._params, dt)
        else:
            self._state = self._step(self._state, self._params, dt)

    def run(self, n_steps: int, dt: Optional[float] = None):
        """n steps, enqueued without waiting for the device."""
        if self.compensated:
            self._state, self._lo = self._run(self._state, self._lo,
                                              self._params, n_steps, dt)
        else:
            self._state = self._run(self._state, self._params, n_steps, dt)
        return self._state

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

    def save(self, path: str):
        """Write a pickle that this package's and the JAX package's
        ``Simulation.load`` both read."""
        with open(path, "wb") as f:
            pickle.dump(self._payload(), f)

    def load(self, path: str):
        """Read a pickle written by ``save`` of either package.  The low
        words of a compensated checkpoint are restored in a compensated
        ``Simulation`` (zeros when the file has none) and ignored in a
        plain one.  The restored point becomes the ``reset`` target."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._state = ParticleState.from_numpy(payload["state"], self.device)
        self._params = SimParams.from_numpy(payload["params"], self.device)
        if self.compensated:
            lo = payload.get("lo")
            self._lo = (init_comp(self._state) if lo is None else tuple(
                torch.as_tensor(lo[k], device=self.device)
                for k in ("pos_lo", "vel_lo")))
        self._initial = self._state
        self._initial_lo = self._lo
        return self
