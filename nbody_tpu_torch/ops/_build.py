"""Build and load the port's CUDA kernels (``nbody_tpu_torch/csrc/*.cu``).

The sources have a plain C interface: ``nvcc`` compiles each of them into
an object in a few seconds (a source that includes PyTorch's headers takes
minutes), all of them at once, links the objects into one shared library,
and ``ctypes`` loads it.  The build happens at first use, never at
import, into ``build/nbody_tpu_torch/`` at the root of the checkout (listed
in ``.gitignore``), under a name keyed by a hash of the sources and flags,
so a changed source is rebuilt and an unchanged one is reused.

Building and loading are safe for concurrent callers: one module lock
guards the build and the first load, so two threads that reach
``load_library`` together (the visualizer's stepping thread and an HTTP
poll) run one nvcc set between them, and the temporary files carry the
thread id beside the pid.

Nothing here falls back: no CUDA device, no ``nvcc`` or a failed compile
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nbody_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
_BUILD_TIMEOUT_S = 900
# guards build() and the first load_library(); re-entrant because
# load_library builds while it holds it
_LOCK = threading.RLock()
_LIB = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of nbody_tpu_torch need the CUDA toolkit"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnbody_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its
    path.  One nvcc per source, all started together, then one link.
    nvcc's output (with the ``-Xptxas -v`` register and shared-memory
    report) goes to ``build.log`` beside the library.  Callers in other
    threads wait for a build in progress and then reuse its library."""
    with _LOCK:
        return _build()


def _build() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(sources, objs)]
    tmp = lib.with_name(f"{tag}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *[str(o) for o in objs]]
    log = []
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        failed = []
        for c, proc in zip(cmds, procs):
            try:
                out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            log.append(" ".join(c) + "\n" + out)
            if proc.returncode != 0:
                failed.append((c[-1], proc.returncode, out))
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True,
                                  timeout=_BUILD_TIMEOUT_S)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(("link", proc.returncode, proc.stderr))
        (BUILD_DIR / "build.log").write_text("".join(log))
        if failed:
            tmp.unlink(missing_ok=True)
            what, rc, out = failed[0]
            raise RuntimeError(
                f"nvcc failed ({what}) with exit code {rc}:\n{out[-4000:]}")
        os.replace(tmp, lib)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels, with every entry point's
    ``argtypes`` and ``restype`` declared.  The first call loads them once
    for the process, whichever thread makes it; later calls return that
    library without taking the lock."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            _LIB = _load()
        return _LIB


def _load() -> ctypes.CDLL:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the kernels of nbody_tpu_torch need an "
            "NVIDIA GPU (use device='cpu' for the plain torch path)"
        )
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nbody_acc_targets.argtypes = [p, i, p, p, i, i, i, f, f, p,
                                      ctypes.c_longlong, p,
                                      ctypes.c_longlong, p, p]
    lib.nbody_acc_targets.restype = i
    lib.nbody_acc_sym.argtypes = [p, p, i, f, f, p, ctypes.c_longlong, p, p]
    lib.nbody_acc_sym.restype = i
    lib.nbody_self_force.argtypes = [p, p, i, i, f, f, p, ctypes.c_longlong,
                                     p, p]
    lib.nbody_self_force.restype = i
    lib.nbody_acc_mxu.argtypes = [p, p, i, i, i, i, i, f, f, p, p, p]
    lib.nbody_acc_mxu.restype = i
    lib.nbody_group_force.argtypes = [p, p, p, i, i, i, i, i, i, f, f, p, p]
    lib.nbody_group_force.restype = i
    lib.nbody_quad_force.argtypes = [p, p, i, i, i, f, f, p, p]
    lib.nbody_quad_force.restype = i
    lib.nbody_sym_tile.argtypes = []
    lib.nbody_sym_tile.restype = i
    lib.nbody_k3_stage.argtypes = []
    lib.nbody_k3_stage.restype = i
    lib.nbody_k4_unroll.argtypes = []
    lib.nbody_k4_unroll.restype = i
    ll = ctypes.c_longlong
    lib.nbody_prefix_table.argtypes = [p, ll, i, i, p, p, p]
    lib.nbody_prefix_table.restype = i
    lib.nbody_prefix_scratch.argtypes = [ll, i]
    lib.nbody_prefix_scratch.restype = ll
    lib.nbody_group_collect.argtypes = [p, i, i, p]
    lib.nbody_group_collect.restype = i
    lib.nbody_collect_params_bytes.argtypes = [i]
    lib.nbody_collect_params_bytes.restype = i
    lib.nbody_rsqrt_sweep.argtypes = [p, p]
    lib.nbody_rsqrt_sweep.restype = i
    lib.nbody_error_string.argtypes = [i]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Raise if an entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} "
            f"({lib.nbody_error_string(rc).decode(errors='replace')})"
        )
