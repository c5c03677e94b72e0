"""Host seconds of a call outside its stages: the hooked call's wall minus
the frontend, encoder, cross K/V, decode and tag stages (entry point:
`transcribe.py`'s assembly, batching and Python around the stages)."""


def read(trace):
    return trace["stages"]["rest_s"]
