"""The control-plane pieces the port's serving engine needs (copied, not imported)."""
