"""The plain float32 reference the benchmark judges the program against."""

from .whisper_at import (  # noqa: F401
    Reference,
    allowed_mask,
    fp32_matmuls,
    log_mel,
    mel_window,
    served_token_gaps,
)
