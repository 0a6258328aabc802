"""Data for the port: latent-feature files and synthetic latents for the
trainer (counterpart of `fast_dit_tpu/data`), the C++ feature loader's
binding, the image-folder pipeline for feature extraction, and the
procedural shapes dataset (`synthetic.py`)."""

from .features import FeatureDataset, feature_batches, synthetic_features
from .imagenet import ImageFolderIndex, center_crop_arr, load_image
from .native_loader import NativeFeatureLoader, build_native_library
from .synthetic import CLASS_NAMES, NUM_CLASSES, class_colors, synth_batch, synth_dataset

__all__ = ["FeatureDataset", "feature_batches", "synthetic_features", "NativeFeatureLoader",
           "build_native_library", "ImageFolderIndex", "center_crop_arr", "load_image",
           "NUM_CLASSES", "CLASS_NAMES", "class_colors", "synth_batch", "synth_dataset"]
