"""Research paths of the port (counterpart of `whisper_at_tpu/research`):
so far the all-layer feature extraction that TL-TR training reads."""

from .feature_extract import (
    extract_feature_set,
    extract_features,
    extract_features_many,
    extract_features_padded,
)

__all__ = ["extract_feature_set", "extract_features", "extract_features_many",
           "extract_features_padded"]
