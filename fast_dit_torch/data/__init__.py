"""Data for the port: latent-feature files and synthetic latents for the
trainer (counterpart of `fast_dit_tpu/data`), the C++ feature loader's
binding, and the image-folder pipeline for feature extraction."""

from .features import FeatureDataset, feature_batches, synthetic_features
from .imagenet import ImageFolderIndex, center_crop_arr, load_image
from .native_loader import NativeFeatureLoader, build_native_library

__all__ = ["FeatureDataset", "feature_batches", "synthetic_features", "NativeFeatureLoader",
           "build_native_library", "ImageFolderIndex", "center_crop_arr", "load_image"]
