"""WHDR metric."""
