"""Backbones of the port."""
