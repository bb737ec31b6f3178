"""Pulse/noise excitation synthesis."""
