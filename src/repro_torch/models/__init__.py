"""Dense decoder of the port: layers and entry points."""
