"""Core simulation state: SoA particle tensors, physics parameters, box bounds.

The PyTorch counterpart of ``nbody_tpu/core/state.py``.  Every state keeps a
fixed capacity and a boolean ``alive`` mask: a particle that leaves the box
is not deleted, its effective mass is zeroed and it is frozen in place, which
is observationally identical to the reference's ``points.retain(contains)``.

Differences from the JAX package:
  * frozen dataclasses of tensors on an explicit ``device``, not pytrees;
  * ``SimParams`` keeps ``g``, ``g_soft``, ``dt`` and ``theta2`` as host
    Python floats (rounded to the state dtype).  JAX traced them to avoid
    recompiles; eager torch has no recompiles, and a device scalar would cost
    a host sync every step wherever a kernel needs epsilon^2 on the host;
  * ``from_numpy`` / ``to_numpy`` use the dict layout of the JAX package's
    checkpoint payload (``nbody_tpu.api.Simulation._payload``), so a pickle
    written by either package loads in the other.

The constructors put their tensors on the card unless the caller passes
``device="cpu"`` (``resolve_device``), as the JAX package's place them on
the default device: without a card they raise rather than run the plain
torch path unasked.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
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


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _as_dtype(x, dtype) -> float:
    """``x`` rounded to ``dtype`` and returned as a host float."""
    return float(torch.tensor(float(x), dtype=dtype))


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bounds:
    """Cubic axis-aligned box.  ``center`` is a length-D tensor, ``half_width``
    a 0-d tensor of the same dtype and device.  Containment is inclusive on
    both faces."""

    center: torch.Tensor  # [D]
    half_width: torch.Tensor  # 0-d

    @staticmethod
    def cube(center, width, dtype=torch.float32, device="cuda") -> "Bounds":
        device = resolve_device(device)
        center = torch.as_tensor(center, dtype=dtype, device=device)
        half = torch.as_tensor(width, dtype=dtype, device=device) * 0.5
        return Bounds(center=center, half_width=half)

    @property
    def width(self) -> torch.Tensor:
        return self.half_width * 2

    @property
    def min(self) -> torch.Tensor:
        return self.center - self.half_width

    @property
    def max(self) -> torch.Tensor:
        return self.center + self.half_width

    def contains(self, pos: torch.Tensor) -> torch.Tensor:
        """pos: [..., D] -> bool [...].  Inclusive on both faces."""
        return ((pos >= self.min) & (pos <= self.max)).all(dim=-1)

    def normalize(self, pos: torch.Tensor) -> torch.Tensor:
        """Map positions into [0, 1)^D relative to the box."""
        return (pos - self.min) / self.width

    def centered(self) -> "Bounds":
        """The same box translated to the origin (grid frame)."""
        return Bounds(center=torch.zeros_like(self.center),
                      half_width=self.half_width)


# ---------------------------------------------------------------------------
# Physics parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimParams:
    """Runtime physics parameters.  The scalars are host floats already
    rounded to the state dtype, so they equal the JAX package's values."""

    g: float  # gravitational constant
    g_soft: float  # Plummer softening length epsilon
    dt: float  # timestep
    theta2: float  # Barnes-Hut opening angle squared (kept for parity)
    bounds: Bounds

    @staticmethod
    def create(
        g=1.0,
        g_soft=0.0,
        dt=1e-3,
        theta2=0.5,
        bounds_center=(0.0, 0.0, 0.0),
        bounds_width=10.0,
        dtype=torch.float32,
        device="cuda",
    ) -> "SimParams":
        return SimParams(
            g=_as_dtype(g, dtype),
            g_soft=_as_dtype(g_soft, dtype),
            dt=_as_dtype(dt, dtype),
            theta2=_as_dtype(theta2, dtype),
            bounds=Bounds.cube(bounds_center, bounds_width, dtype=dtype,
                               device=device),
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.bounds.center.dtype

    @property
    def eps2(self) -> float:
        """epsilon^2 computed in the state dtype, as the JAX package does."""
        e = torch.tensor(self.g_soft, dtype=self.dtype)
        return float(e * e)

    def replace(self, **kw) -> "SimParams":
        if "bounds_center" in kw or "bounds_width" in kw:
            center = kw.pop("bounds_center", self.bounds.center)
            width = kw.pop("bounds_width", self.bounds.width)
            kw["bounds"] = Bounds.cube(center, width, dtype=self.dtype,
                                       device=self.bounds.center.device)
        clean = {k: (v if k == "bounds" else _as_dtype(v, self.dtype))
                 for k, v in kw.items()}
        return dataclasses.replace(self, **clean)

    @staticmethod
    def from_numpy(p: dict, device="cuda") -> "SimParams":
        """From the ``params`` dict of a checkpoint payload."""
        device = resolve_device(device)
        center = torch.as_tensor(np.asarray(p["bounds_center"]), device=device)
        return SimParams(
            g=float(p["g"]),
            g_soft=float(p["g_soft"]),
            dt=float(p["dt"]),
            theta2=float(p["theta2"]),
            bounds=Bounds(
                center=center,
                half_width=torch.as_tensor(np.asarray(p["bounds_half_width"]),
                                           device=device),
            ),
        )

    def to_numpy(self) -> dict:
        """The ``params`` dict of a checkpoint payload."""
        np_dtype = self.bounds.center.cpu().numpy().dtype
        scalar = lambda v: np.asarray(v, dtype=np_dtype)
        return {
            "g": scalar(self.g),
            "g_soft": scalar(self.g_soft),
            "dt": scalar(self.dt),
            "theta2": scalar(self.theta2),
            "bounds_center": self.bounds.center.cpu().numpy(),
            "bounds_half_width": self.bounds.half_width.cpu().numpy(),
        }


# ---------------------------------------------------------------------------
# Particle state
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParticleState:
    """SoA particle tensors with fixed capacity and an alive mask, plus the
    simulation clock ``time`` (a 0-d tensor, so stepping needs no host
    sync)."""

    pos: torch.Tensor  # [cap, D]
    vel: torch.Tensor  # [cap, D]
    acc: torch.Tensor  # [cap, D]
    mass: torch.Tensor  # [cap]
    alive: torch.Tensor  # [cap] bool
    time: torch.Tensor  # 0-d

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def n_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def effective_mass(self) -> torch.Tensor:
        """Mass with dead particles zeroed: the only mass force engines see."""
        return torch.where(self.alive, self.mass, torch.zeros_like(self.mass))

    @staticmethod
    def create(
        pos,
        vel,
        mass,
        *,
        capacity: int | None = None,
        pad_multiple: int = 128,
        dtype=torch.float32,
        time=0.0,
        device="cuda",
    ) -> "ParticleState":
        """Build a state from [N, D] arrays, padding capacity up to a multiple
        of ``pad_multiple`` with dead particles (zero mass, ``alive=False``,
        parked at the origin).  Rounds from float64 exactly as the JAX
        package does, so both packages start from identical bits."""
        device = resolve_device(device)
        pos = np.asarray(pos, dtype=np.float64)
        vel = np.asarray(vel, dtype=np.float64)
        mass = np.asarray(mass, dtype=np.float64)
        n, d = pos.shape
        if capacity is None:
            capacity = max(_round_up(n, pad_multiple), pad_multiple)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < n {n}")

        def pad(a, shape):
            out = np.zeros(shape, dtype=np.float64)
            out[:n] = a
            return torch.as_tensor(out).to(device=device, dtype=dtype)

        alive = np.zeros((capacity,), dtype=bool)
        alive[:n] = True
        return ParticleState(
            pos=pad(pos, (capacity, d)),
            vel=pad(vel, (capacity, d)),
            acc=torch.zeros((capacity, d), dtype=dtype, device=device),
            mass=pad(mass, (capacity,)),
            alive=torch.as_tensor(alive, device=device),
            time=torch.tensor(time, dtype=dtype, device=device),
        )

    # -- host-side particle management.  These return new states of the SAME
    #    capacity, like the JAX package's.

    def add_point(self, pos, vel, mass) -> "ParticleState":
        """Occupy the first dead slot (errors if the state is full)."""
        free = np.nonzero(~self.alive.cpu().numpy())[0]
        if len(free) == 0:
            raise ValueError(
                "state is at capacity; rebuild with a larger capacity to add points"
            )
        i = int(free[0])

        def put(a, v):
            a = a.clone()
            a[i] = torch.as_tensor(v, dtype=a.dtype)
            return a

        return dataclasses.replace(
            self,
            pos=put(self.pos, pos),
            vel=put(self.vel, vel),
            acc=put(self.acc, 0.0),
            mass=put(self.mass, mass),
            alive=put(self.alive, True),
        )

    def remove_point(self, index: int) -> "ParticleState":
        """Kill the index-th *alive* particle."""
        i = int(np.nonzero(self.alive.cpu().numpy())[0][index])
        alive, mass = self.alive.clone(), self.mass.clone()
        alive[i] = False
        mass[i] = 0
        return dataclasses.replace(self, alive=alive, mass=mass)

    def get_points(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(pos, vel, acc, mass) of alive particles as numpy arrays."""
        alive = self.alive.cpu().numpy()
        return tuple(a.cpu().numpy()[alive]
                     for a in (self.pos, self.vel, self.acc, self.mass))

    # -- checkpoint payload layout (shared with the JAX package)

    @staticmethod
    def from_numpy(s: dict, device="cuda") -> "ParticleState":
        """From the ``state`` dict of a checkpoint payload."""
        device = resolve_device(device)
        t = lambda k: torch.as_tensor(np.asarray(s[k]), device=device)
        return ParticleState(pos=t("pos"), vel=t("vel"), acc=t("acc"),
                             mass=t("mass"), alive=t("alive"), time=t("time"))

    def to_numpy(self) -> dict:
        """The ``state`` dict of a checkpoint payload."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}
