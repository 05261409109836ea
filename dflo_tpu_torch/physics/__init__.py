"""Euler physics and numerical fluxes."""
