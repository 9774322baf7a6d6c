"""Geometry: cameras, closed-form small solves, triangulation."""
