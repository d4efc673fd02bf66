"""Host-side data pipeline (the serving slice needs only the eval transform)."""

from .augment import EvalTransform, resize, to_normalized_array

__all__ = ["EvalTransform", "resize", "to_normalized_array"]
