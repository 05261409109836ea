"""Stabilization chain: shock indicator, TVB limiter, positivity limiter."""
