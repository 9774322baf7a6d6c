"""The map model: frames, map store, device point mirror."""
from .frame import Frame, FrameFactory  # noqa: F401
from .mapstore import MapStore  # noqa: F401
