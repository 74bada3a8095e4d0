"""Measurement and operator tools of the port (not on its main path)."""
