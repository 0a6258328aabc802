"""Device resolution and image helpers."""
