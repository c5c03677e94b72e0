"""Tagging seconds of a call (`models/at_head.py`): the hooked call's
`Whisper.at_forward`."""


def read(trace):
    return trace["stages"]["tags_s"]
