"""Device resolution, image helpers and the trainer's logger."""
