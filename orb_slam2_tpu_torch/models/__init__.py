"""The map model: frames, map store, device point mirror."""
