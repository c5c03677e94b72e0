"""Model dimensions of the Whisper family and the table of official sizes."""

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_head: int
    n_text_state: int
    n_text_layer: int


MULTILINGUAL_VOCAB = 51865
ENGLISH_VOCAB = 51864

# (width, heads, layers) per size; the audio and text stacks share them
SIZES = {
    "tiny": (384, 6, 4),
    "base": (512, 8, 6),
    "small": (768, 12, 12),
    "medium": (1024, 16, 24),
    "large-v1": (1280, 20, 32),
    "large-v2": (1280, 20, 32),
    "large": (1280, 20, 32),
}


def dims_for(name: str) -> ModelDimensions:
    """Dimensions of an official model name (e.g. 'small.en', 'large-v1')."""
    english = name.endswith(".en")
    size = name[:-3] if english else name
    if size not in SIZES:
        raise ValueError(f"Unknown model size: {name}")
    width, heads, layers = SIZES[size]
    return ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=width, n_audio_head=heads,
        n_audio_layer=layers,
        n_vocab=ENGLISH_VOCAB if english else MULTILINGUAL_VOCAB,
        n_text_ctx=448, n_text_head=heads, n_text_state=width, n_text_layer=layers,
    )
