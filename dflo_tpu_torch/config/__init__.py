"""The .prm configuration layer: parser, expression compiler, parameters."""
