"""Training steps (single device so far)."""
