"""Decoder milliseconds a step (`models/decoder.py`, `decoding.py`, K4):
the hooked call's `greedy_sample_loop` seconds over the steps it ran."""


def read(trace):
    steps = trace["stages"]["decode_steps"]
    return trace["stages"]["decode_s"] / steps * 1e3 if steps else None
