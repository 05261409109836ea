"""Solution output (VTU) and checkpoints."""
