"""Harvest, CheapTrick, D4C and the device contour chain."""
