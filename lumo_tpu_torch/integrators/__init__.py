"""Wavefront integrators."""
