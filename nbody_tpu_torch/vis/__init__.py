"""The visualizer server of the port (``vis/server.py``)."""

from nbody_tpu_torch.vis.server import VisServer, run

__all__ = ["run", "VisServer"]
