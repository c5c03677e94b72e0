"""Audio seconds of every call completed in the window over the window's
wall time, from the first call's start to the last call's end."""


def read(run):
    window = run["window"]
    return window["audio_s"] / window["wall_s"]
