"""Geometry: cameras, closed-form small solves, triangulation."""
from . import se3, sim3, camera, triangulate, horn  # noqa: F401
