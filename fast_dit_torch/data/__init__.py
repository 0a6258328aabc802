"""Latent-feature data for the trainer (counterpart of `fast_dit_tpu/data`,
feature files and synthetic latents only)."""

from .features import FeatureDataset, feature_batches, synthetic_features

__all__ = ["FeatureDataset", "feature_batches", "synthetic_features"]
