"""Tracking step and the host-side system object."""
