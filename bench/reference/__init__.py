"""Plain PyTorch references the served tokens are held against."""
