"""Solvers: structure-only bundle adjustment."""
