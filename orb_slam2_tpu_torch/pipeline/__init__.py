"""Tracking, local mapping and the System facade."""
