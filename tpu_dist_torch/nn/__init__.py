"""Models of the port: attention and the Vision Transformer."""
