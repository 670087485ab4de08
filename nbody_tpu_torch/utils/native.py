"""ctypes bindings for the native C++ oracle (``native/oracle.cpp``), a copy
of ``nbody_tpu/utils/native.py`` that this package can import without the
JAX package.

The oracle is the external ground truth: a serial float64 leapfrog with a
direct-sum or recursive-octree force and the reference's step semantics,
compiled with strict floating point (no fast-math).  It is built at first
use with ``g++`` and the flags of ``native/Makefile`` into
``build/nbody_tpu_torch/`` (listed in ``.gitignore``), under a name keyed by
a hash of the source and flags; ``native/`` itself is never written.  A
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from nbody_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "oracle.cpp"
# native/Makefile's CXXFLAGS; strict FP: this is the ground-truth oracle
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"liboracle_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the oracle unless a library for this source exists; return
    its path.  The library is written under a temporary name and renamed,
    so concurrent builds never load a partial file."""
    lib = library_path()
    if lib.exists():
        return str(lib)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native oracle needs a C++ "
                           "compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    return str(lib)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    d = ctypes.POINTER(ctypes.c_double)
    lib.oracle_run.restype = ctypes.c_int64
    lib.oracle_run.argtypes = [d, d, d, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int64] + [ctypes.c_double] * 8
    lib.oracle_forces.restype = None
    lib.oracle_forces.argtypes = [d, d, ctypes.c_int64, ctypes.c_int] + \
        [ctypes.c_double] * 7 + [d]
    lib.oracle_energy.restype = ctypes.c_double
    lib.oracle_energy.argtypes = [d, d, d, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double]
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


METHODS = {"brute": 0, "bh": 1}


def oracle_run(pos, vel, mass, *, method="brute", steps=1, dt=1e-3, g=1.0,
               g_soft=0.0, theta2=0.5, box_center=(0.0, 0.0, 0.0),
               box_width=10.0):
    """Run the oracle integrator; returns (pos, vel, mass) of survivors."""
    lib = load()
    pos = np.ascontiguousarray(pos, dtype=np.float64).copy()
    vel = np.ascontiguousarray(vel, dtype=np.float64).copy()
    mass = np.ascontiguousarray(mass, dtype=np.float64).copy()
    n = len(mass)
    left = lib.oracle_run(
        _dp(pos), _dp(vel), _dp(mass), n, METHODS[method], steps,
        dt, g, g_soft, theta2, box_center[0], box_center[1], box_center[2],
        box_width,
    )
    return pos[:left], vel[:left], mass[:left]


def oracle_forces(pos, mass, *, method="brute", g=1.0, g_soft=0.0,
                  theta2=0.5, box_center=(0.0, 0.0, 0.0), box_width=10.0):
    lib = load()
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    mass = np.ascontiguousarray(mass, dtype=np.float64)
    acc = np.zeros_like(pos)
    lib.oracle_forces(
        _dp(pos), _dp(mass), len(mass), METHODS[method], g, g_soft, theta2,
        box_center[0], box_center[1], box_center[2], box_width, _dp(acc),
    )
    return acc


def oracle_energy(pos, vel, mass, *, g=1.0, g_soft=0.0):
    lib = load()
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    vel = np.ascontiguousarray(vel, dtype=np.float64)
    mass = np.ascontiguousarray(mass, dtype=np.float64)
    return float(lib.oracle_energy(_dp(pos), _dp(vel), _dp(mass), len(mass),
                                   g, g_soft))
