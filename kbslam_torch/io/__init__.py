"""Host-side data sources of the port (numpy)."""
