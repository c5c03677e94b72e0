"""Encoder seconds of a call (`models/encoder.py`, K1 and K2): the hooked
call's `Whisper.embed_audio`."""


def read(trace):
    return trace["stages"]["encoder_s"]
