"""Measurement tools of the port that run on the card (not on its main path)."""
