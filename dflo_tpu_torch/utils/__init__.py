"""Wall-time profiling scopes."""
