"""Faults planted in the program's timed path, for the checks that the
comparison sees them (`tests/test_portbench_faults.py` on the CPU,
`readings.py --faults` on the card at a cell's size). Each takes a
`pytest.MonkeyPatch` and patches the program until it is undone. These
cells run on one chip, so there is no exchange between chips to leave out.
"""

import importlib

import torch


def token_altered(monkeypatch):
    """The greedy loop's first sampled token of every row is changed."""
    decoding = importlib.import_module("whisper_at_tpu_torch.decoding")
    real = decoding.greedy_sample_loop

    def loop(*args, **kwargs):
        buf, sum_lp, no_speech, t = real(*args, **kwargs)
        slot = kwargs["prefill"]
        buf[:, slot] = (buf[:, slot] + 1) % 50257
        return buf, sum_lp, no_speech, t

    monkeypatch.setattr(decoding, "greedy_sample_loop", loop)


def tags_altered(monkeypatch):
    """The TL-TR head's logits are moved by 5% where they are produced."""
    from whisper_at_tpu_torch.models.whisper import Whisper

    real = Whisper.at_forward
    monkeypatch.setattr(Whisper, "at_forward", lambda self, *a, **k: real(self, *a, **k) * 1.05)


def half_the_batch(monkeypatch):
    """The encoder runs the first half of a batch's windows; the rest get
    copies of their results."""
    from whisper_at_tpu_torch.models.whisper import Whisper

    real = Whisper.embed_audio

    def embed(self, mel, fp16=True):
        half = max(1, mel.shape[0] // 2)
        feats, taps = real(self, mel[:half], fp16)
        idx = torch.arange(mel.shape[0], device=mel.device) % half
        return feats[idx], taps[idx]

    monkeypatch.setattr(Whisper, "embed_audio", embed)


def step_unchanged(monkeypatch):
    """Every decode step returns the state it was given: the prefill's last
    hidden state, the cache unwritten."""
    decoding = importlib.import_module("whisper_at_tpu_torch.decoding")
    real = decoding.decoder_forward
    last = {}

    def forward(params, tokens, *args, **kwargs):
        if tokens.shape[1] > 1 or "h" not in last:
            hidden = real(params, tokens, *args, **kwargs)
            last["h"] = hidden[:, -1:]
            return hidden
        return last["h"]

    monkeypatch.setattr(decoding, "decoder_forward", forward)


FAULTS = {"token_altered": token_altered, "tags_altered": tags_altered,
          "half_the_batch": half_the_batch, "step_unchanged": step_unchanged}
