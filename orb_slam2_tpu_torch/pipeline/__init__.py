"""Tracking, local mapping and the System facade."""
from .config import SlamConfig  # noqa: F401
from .system import System, TrackState  # noqa: F401
