"""Caffemodel converter, the reflectance networks and R/S recovery."""
