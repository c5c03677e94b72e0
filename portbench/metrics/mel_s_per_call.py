"""Frontend seconds of a call (`ops/mel.py`, `audio.py`): the hooked call's
`log_mel_spectrogram` (transcribe_batched) or `_frontend_many` (host prep,
copy and batched mel of transcribe_many)."""


def read(trace):
    return trace["stages"]["mel_s"]
