"""Small host-side helpers: integer division, zlib compression ratio,
timestamp formatting, console-safe strings and the command line's argument
types, and the output writers of `utils.writers`, re-exported here as the
JAX package's `utils` (and upstream Whisper's `whisper.utils`) does."""

import sys
import zlib

_ENCODING = sys.getdefaultencoding()


def exact_div(x: int, y: int) -> int:
    if x % y:
        raise ValueError(f"{x} is not a multiple of {y}")
    return x // y


def str2bool(string: str) -> bool:
    """'True' or 'False' (the command line's booleans)."""
    values = {"True": True, "False": False}
    if string not in values:
        raise ValueError(f"Expected one of {set(values)}, got {string}")
    return values[string]


def optional_int(string: str):
    return None if string == "None" else int(string)


def optional_float(string: str):
    return None if string == "None" else float(string)


def compression_ratio(text: str) -> float:
    """Bytes of the UTF-8 text over bytes of its zlib compression; a high
    ratio flags a degenerate, repetitive decode."""
    data = text.encode("utf-8")
    return len(data) / len(zlib.compress(data))


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    """[hh:]mm:ss.mmm for a non-negative time in seconds."""
    if seconds < 0:
        raise ValueError("non-negative timestamp expected")
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    head = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{head}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def make_safe(text: str) -> str:
    """Replace characters the console encoding cannot show with '?'."""
    if _ENCODING == "utf-8":
        return text
    return text.encode(_ENCODING, errors="replace").decode(_ENCODING)


def resolve_device(device="cuda"):
    """torch.device for `device`; raises when the card is asked for and absent."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


from .writers import (  # noqa: E402  (the writers import format_timestamp above)
    ResultWriter,
    WriteJSON,
    WriteSRT,
    WriteTSV,
    WriteTXT,
    WriteVTT,
    get_writer,
)
