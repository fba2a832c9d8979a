"""Offline evaluation of the port's trajectories (numpy)."""
