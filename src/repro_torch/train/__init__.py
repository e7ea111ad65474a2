"""Serving entry points of the port (training comes in a later slice)."""
