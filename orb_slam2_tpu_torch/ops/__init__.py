"""The ORB feature pipeline (pyramid, FAST, distribution, orientation, BRIEF)."""
