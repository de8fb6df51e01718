"""Dataset loading (numpy)."""
