"""Research paths of the port (counterpart of `whisper_at_tpu/research`):
the all-layer feature extraction that TL-TR training reads, word error
rates and noisy test sets for the noise-robustness curve, the AudioSet
evaluation, the layer-wise probe, the paper's figures and the wav2vec2 /
HuBERT baselines. Importing it loads no scikit-learn, matplotlib or
transformers."""

from .feature_extract import (
    extract_feature_set,
    extract_features,
    extract_features_many,
    extract_features_padded,
)
from .layer_probe import layer_wise_probe
from .noisy_speech import add_noise, generate_noisy_set
from .wer import calculate_wer, remove_punctuation, word_edit_distance

__all__ = ["add_noise", "calculate_wer", "extract_feature_set", "extract_features",
           "extract_features_many", "extract_features_padded", "generate_noisy_set",
           "layer_wise_probe", "remove_punctuation", "word_edit_distance"]
