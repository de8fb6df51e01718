"""Caffemodel converter and the flagship reflectance network."""
