"""The plain reference against the program's CPU path (its plain twins) in
float32, and the comparison failing when the program or the reference runs
one precision lower."""

import numpy as np
import pytest
import torch

from portbench import bench, check, generator
from portbench.conftest import SMALL_DIMS, make_small_root, small_config
from portbench.reference import Reference, log_mel, mel_window
from portbench.weights import leaves, make_weights

CPU = torch.device("cpu")
# between what the fp32 program with its int8 options reads against the
# reference, which works out the same int8 codes (tag_err 2-3e-7,
# no_speech_err and logprob_err at most 6.3e-5, token_gap 0 on seeds 1-3
# and 11), and what its int4 path (no_speech_err 0.0038-0.0236,
# logprob_err 0.0066-0.0186) and the fp8 reference (tag_err 0.048-0.064) read
SMALL_LIMITS = {"tag_err": 1e-3, "no_speech_err": 1e-3, "logprob_err": 1e-3,
                "token_gap": 0.01, "missing": 0}


@pytest.fixture(scope="module")
def small():
    config = small_config()
    sd = make_weights(config["dims"], 3, CPU, torch.float32)
    return config, sd, bench.build_model(config, sd, CPU)


def test_weights_are_the_programs_parameters_by_name(small):
    _, sd, model = small
    assert list(sd) == [name for name, *_ in leaves(SMALL_DIMS)]
    assert set(sd) == set(model.state_dict())
    base = min(t.data_ptr() for t in sd.values())  # one buffer, 512-byte aligned leaves
    assert all((t.data_ptr() - base) % 512 == 0 for t in sd.values())
    again = make_weights(SMALL_DIMS, 3, CPU, torch.float32)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = make_weights(SMALL_DIMS, 4, CPU, torch.float32)
    assert not torch.equal(sd["decoder.blocks.0.mlp.0.weight"],
                           other["decoder.blocks.0.mlp.0.weight"])
    bound = 1 / np.sqrt(64)
    w = sd["encoder.blocks.1.attn.query.weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert torch.equal(sd["decoder.ln.weight"], torch.ones(64))


def test_log_mel_matches_the_programs(small):
    from whisper_at_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram

    mix = dict(seconds_per_file=45, files_per_call=1, tone_hz=[100, 4000], segment_seconds=30,
               tone_amplitude=0.3, noise_amplitude=0.05)
    pcm = generator.make_call_audio(mix, 5, 0, CPU)[0]
    want = log_mel(pcm, CPU)
    got = log_mel_spectrogram(pcm, padding=N_SAMPLES, device="cpu")
    assert want.shape == got.shape
    assert float((want - got).abs().max()) < 2e-4


def test_encoder_tags_and_logits_match_the_programs_fp32_path(small):
    config, sd, model = small
    ref = Reference(sd, config["dims"], config["at_mode"])
    mel = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(0)) * 0.5
    want_f, want_taps = ref.encode(mel)
    got_f, got_taps = model.embed_audio(mel, fp16=False)
    scale = float(want_f.abs().max())
    assert float((want_f - got_f).abs().max()) < 1e-4 * scale
    assert float((want_taps - got_taps).abs().max()) < 1e-4 * float(want_taps.abs().max())
    want_tags = ref.tags(want_taps)
    got_tags = model.at_forward(want_taps, 10)
    assert float((want_tags - got_tags).abs().max()) < 1e-4 * float(want_tags.abs().max())
    tokens = torch.tensor([[50258, 50259, 50359, 50363, 400, 17, 9025, 1000]] * 2)
    want_l = ref.logits(tokens, want_f)
    got_l = model.logits(tokens, want_f, fp16=False)
    assert float((want_l - got_l).abs().max()) < 1e-4 * float(want_l.abs().max())


def test_mel_window_pads_the_last_window():
    mel = torch.arange(80 * 4500, dtype=torch.float32).reshape(80, 4500)
    assert torch.equal(mel_window(mel, 0), mel[:, :3000])
    tail = mel_window(mel, 1)
    assert torch.equal(tail[:, :1500], mel[:, 3000:]) and not tail[:, 1500:].any()


def readings(root, seed, control: bool):
    spec = bench.load_cell(root, "small.small_long")
    config, mix = spec["config"], spec["mix"]
    options = generator.call_options(mix, config)
    if control:
        options.update(config["control"])
    sd = make_weights(config["dims"], seed, CPU, torch.float32)
    model = bench.build_model(config, sd, CPU)
    files = generator.make_call_audio(mix, seed, 0, CPU)
    call = generator.load_entry(spec["dir"], mix["entry"]).call
    calls = [{"pool": 0, "windows": generator.windows_of(files),
              "results": call(model, files, options)}]
    got = check.compare(calls, [files], sd, config, mix["check_windows"], seed, CPU)
    low_calls = check.reference_as_program(calls, [files], sd, config, mix["check_windows"],
                                           seed, CPU)
    low = check.compare(low_calls, [files], sd, config, mix["check_windows"], seed, CPU)
    return got, low


def test_the_reference_in_the_programs_place_reads_nought(tmp_path):
    # the control's path at the reference's own precision: its answers are
    # the reference's, so every number reads (nearly) nought
    root = make_small_root(tmp_path, limits=SMALL_LIMITS)
    spec = bench.load_cell(root, "small.small_many")
    config, mix = spec["config"], spec["mix"]
    sd = make_weights(config["dims"], 7, CPU, torch.float32)
    model = bench.build_model(config, sd, CPU)
    files = generator.make_call_audio(mix, 7, 0, CPU)
    call = generator.load_entry(spec["dir"], mix["entry"]).call
    calls = [{"pool": 0, "windows": generator.windows_of(files),
              "results": call(model, files, generator.call_options(mix, config))}]
    same = check.reference_as_program(calls, [files], sd, config, 3, 7, CPU, matmul_bits=None)
    got = check.compare(same, [files], sd, config, 3, 7, CPU)
    assert got["token_gap"] == 0 and got["tag_err"] == 0 and got["missing"] == 0
    assert got["logprob_err"] < 1e-5 and got["no_speech_err"] < 1e-5


@pytest.mark.parametrize("seed", [1, 2])
def test_the_comparison_fails_one_precision_lower(tmp_path, seed):
    root = make_small_root(tmp_path, limits=SMALL_LIMITS)
    sound, fp8_reference = readings(root, seed, control=False)
    int4, _ = readings(root, seed, control=True)
    assert all(check.judge(sound, SMALL_LIMITS)[k]["ok"] for k in SMALL_LIMITS)
    assert not all(j["ok"] for j in check.judge(int4, SMALL_LIMITS).values())
    assert fp8_reference["missing"] == 0
    assert not all(j["ok"] for j in check.judge(fp8_reference, SMALL_LIMITS).values())
    assert int4["no_speech_err"] >= 3 * sound["no_speech_err"]
    assert int4["logprob_err"] >= 3 * sound["logprob_err"]
    assert fp8_reference["tag_err"] >= 1000 * sound["tag_err"]
