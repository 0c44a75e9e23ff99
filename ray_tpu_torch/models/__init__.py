"""Models on PyTorch."""
