"""Utilities: parameter inspection (``debug``)."""
