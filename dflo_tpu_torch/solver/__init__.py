"""Spatial residual and SSP-RK time stepping."""
