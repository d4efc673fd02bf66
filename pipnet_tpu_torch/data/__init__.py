"""Host-side data pipeline: ImageFolder, the two-view and eval transforms,
the loaders, the synthetic fixture and the device-resident cache."""

from .augment import (EvalTransform, TrivialAugment, TwoViewTransform, resize,
                      to_normalized_array, trivial_augment_no_color,
                      trivial_augment_no_shape, trivial_augment_no_shape_with_color)
from .device_cache import DeviceDataCache, build_device_cache, estimate_bytes
from .folder import ImageFolder, scan_image_folder
from .loader import (Batch, EvalDataset, Loader, Loaders, TwoViewDataset,
                     build_loaders, reference_drop_last, stratified_split)
from .node_loader import NodeFilteredLoader
from .synthetic import generate_synthetic_dataset, synthetic_class_names

__all__ = [
    "EvalTransform", "TrivialAugment", "TwoViewTransform", "resize",
    "to_normalized_array", "trivial_augment_no_color", "trivial_augment_no_shape",
    "trivial_augment_no_shape_with_color",
    "DeviceDataCache", "build_device_cache", "estimate_bytes",
    "ImageFolder", "scan_image_folder",
    "Batch", "EvalDataset", "Loader", "Loaders", "TwoViewDataset",
    "build_loaders", "reference_drop_last", "stratified_split",
    "NodeFilteredLoader",
    "generate_synthetic_dataset", "synthetic_class_names",
]
