"""The card a run measures, and the guard on what the run loaded.

A run needs as many CUDA cards as its cell asks for and stops without a
result otherwise: nothing here falls back to the CPU.  After the window the
process must hold no module of JAX or of the JAX package (``nbody_tpu``):
the port's name begins with the JAX package's, so modules are compared by
their whole top-level name.
"""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(torch, chips: int):
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "measures the port on a CUDA card and has none")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is a forbidden one."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".", 1)[0] in FORBIDDEN)
