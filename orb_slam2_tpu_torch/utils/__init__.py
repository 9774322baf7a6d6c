"""Synthetic scenes, PLY export, logging."""
