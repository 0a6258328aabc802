"""Data for the port: latent-feature files and synthetic latents for the
trainer (counterpart of `fast_dit_tpu/data`), and the image-folder pipeline
for feature extraction."""

from .features import FeatureDataset, feature_batches, synthetic_features
from .imagenet import ImageFolderIndex, center_crop_arr, load_image

__all__ = ["FeatureDataset", "feature_batches", "synthetic_features", "ImageFolderIndex",
           "center_crop_arr", "load_image"]
