"""Visualization egress of the port (the Rerun viewer)."""
