"""Host-side utilities of the port: logging macros and profiling."""
