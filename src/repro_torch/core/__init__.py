"""The control-plane pieces the port's engine, substrates and fleet runner need (copied, not imported)."""
