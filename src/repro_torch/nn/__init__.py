"""Functional layer substrate: params are nested dicts of tensors."""
