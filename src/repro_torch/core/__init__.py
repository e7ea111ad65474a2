"""Numerics core of the port: formats, QDQ, recipes, packed panels and
the quantized linear."""
