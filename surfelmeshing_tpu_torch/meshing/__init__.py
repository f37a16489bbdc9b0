"""Asynchronous meshing of the port: the reference's meshing thread
(driver.py) over the native advancing-front engine (engine.py)."""

from .driver import MeshingDriver

__all__ = ["MeshingDriver"]
