"""Command line for transcription and tagging: `python -m
whisper_at_tpu_torch audio.wav --model large-v1 --at_time_res 10`.

Counterpart of `whisper_at_tpu/cli.py`, flag for flag with the same
defaults, the same checks before the model loads and the same temperature
ladder, plus `--device` (default `cuda`): the model and every pass run on
the card unless `--device cpu` is given, and without a card the command
raises. Official model names are read from `--model_dir` (nothing is
downloaded); `--model` also takes a local `.npz` or `.pt` checkpoint. One
file of each `--output_format` is written per audio into `--output_dir`.
With `--batched True`, several files run through `transcribe_many`, one
through `transcribe_batched`; otherwise each file runs through the
sequential `transcribe`.
"""

import argparse
import os
import warnings

import numpy as np

from .languages import LANGUAGES, TO_LANGUAGE_CODE
from .utils import optional_float, optional_int, resolve_device, str2bool
from .utils.writers import get_writer


def build_parser() -> argparse.ArgumentParser:
    # fmt: off
    parser = argparse.ArgumentParser(prog="whisper_at_tpu_torch",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    parser.add_argument("--model", default="small", help="name of the Whisper model to use (read from --model_dir), or a path to a local checkpoint (.npz of the JAX package's parameters with its dims, or a Whisper .pt — pair the latter with --at_checkpoint for tagging)")
    parser.add_argument("--at_checkpoint", type=str, default=None, help="local TL-TR head .pth to merge when --model is a local .pt")
    parser.add_argument("--batched", type=str2bool, default=False, help="decode all 30s windows of a file in parallel batches (implies condition_on_previous_text=False); several files share the batches")
    parser.add_argument("--model_dir", type=str, default=None, help="the directory holding the official model files; ~/.cache/whisper by default (nothing is downloaded)")
    parser.add_argument("--device", type=str, default="cuda", help="device to run on: cuda (the card), or cpu")
    parser.add_argument("--output_dir", "-o", type=str, default=".", help="directory to save the outputs")
    parser.add_argument("--output_format", "-f", type=str, default="all", choices=["txt", "vtt", "srt", "tsv", "json", "all"], help="format of the output file; if not specified, all available formats will be produced")
    parser.add_argument("--verbose", type=str2bool, default=True, help="whether to print out progress and debug messages")

    parser.add_argument("--task", type=str, default="transcribe", choices=["transcribe", "translate"], help="whether to perform X->X speech recognition ('transcribe') or X->English translation ('translate')")
    parser.add_argument("--language", type=str, default=None, choices=sorted(LANGUAGES.keys()) + sorted([k.title() for k in TO_LANGUAGE_CODE.keys()]), help="language spoken in the audio, specify None to perform language detection")

    parser.add_argument("--at_time_res", type=float, default=10, help="audio tagging time resolution in seconds; must be a multiple of 0.4")
    parser.add_argument("--at_low_compute", type=str2bool, default=False, help="use the low-compute TL-TR-512 tagging head")

    parser.add_argument("--temperature", type=float, default=0, help="temperature to use for sampling")
    parser.add_argument("--best_of", type=optional_int, default=5, help="number of candidates when sampling with non-zero temperature")
    parser.add_argument("--beam_size", type=optional_int, default=5, help="number of beams in beam search, only applicable when temperature is zero")
    parser.add_argument("--patience", type=float, default=None, help="optional patience value to use in beam decoding, as in https://arxiv.org/abs/2204.05424, the default (1.0) is equivalent to conventional beam search")
    parser.add_argument("--length_penalty", type=float, default=None, help="optional token length penalty coefficient (alpha) as in https://arxiv.org/abs/1609.08144, uses simple length normalization by default")

    parser.add_argument("--suppress_tokens", type=str, default="-1", help="comma-separated list of token ids to suppress during sampling; '-1' will suppress most special characters except common punctuations")
    parser.add_argument("--initial_prompt", type=str, default=None, help="optional text to provide as a prompt for the first window")
    parser.add_argument("--condition_on_previous_text", type=str2bool, default=True, help="if True, provide the previous output of the model as a prompt for the next window")
    parser.add_argument("--fp16", type=str2bool, default=True, help="whether to perform inference in half precision (bfloat16)")

    parser.add_argument("--temperature_increment_on_fallback", type=optional_float, default=0.2, help="temperature to increase when falling back when the decoding fails to meet either of the thresholds below")
    parser.add_argument("--compression_ratio_threshold", type=optional_float, default=2.4, help="if the gzip compression ratio is higher than this value, treat the decoding as failed")
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0, help="if the average log probability is lower than this value, treat the decoding as failed")
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6, help="if the probability of the <|nospeech|> token is higher than this value AND the decoding has failed due to `logprob_threshold`, consider the segment as silence")
    parser.add_argument("--word_timestamps", type=str2bool, default=False, help="(experimental) extract word-level timestamps and refine the results based on them")
    parser.add_argument("--prepend_punctuations", type=str, default="\"'“¿([{-", help="if word_timestamps is True, merge these punctuation symbols with the next word")
    parser.add_argument("--append_punctuations", type=str, default="\"'.。,，!！?？:：”)]}、", help="if word_timestamps is True, merge these punctuation symbols with the previous word")
    parser.add_argument("--highlight_words", type=str2bool, default=False, help="(requires --word_timestamps True) underline each word as it is spoken in srt and vtt")
    parser.add_argument("--max_line_width", type=optional_int, default=None, help="(requires --word_timestamps True) the maximum number of characters in a line before breaking the line")
    parser.add_argument("--max_line_count", type=optional_int, default=None, help="(requires --word_timestamps True) the maximum number of lines in a segment")
    # fmt: on
    return parser


def cli(argv=None) -> None:
    from . import available_models, load_model
    from .transcribe import transcribe, transcribe_batched, transcribe_many

    parser = build_parser()
    args = parser.parse_args(argv).__dict__
    model_name: str = args.pop("model")
    at_checkpoint = args.pop("at_checkpoint")
    batched: bool = args.pop("batched")
    model_dir: str = args.pop("model_dir")
    device: str = args.pop("device")
    output_dir: str = args.pop("output_dir")
    output_format: str = args.pop("output_format")
    at_low_compute: bool = args.pop("at_low_compute")
    os.makedirs(output_dir, exist_ok=True)

    if model_name not in available_models() and not os.path.isfile(model_name):
        parser.error(f"--model must be an official name {available_models()} or a "
                     f"local checkpoint path; got {model_name!r}")

    if model_name.endswith(".en") and args["language"] not in {"en", "English"}:
        if args["language"] is not None:
            warnings.warn(f"{model_name} is an English-only model but received "
                          f"'{args['language']}'; using English instead.")
        args["language"] = "en"

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    # flag combinations are checked before the model loads
    word_options = ["highlight_words", "max_line_count", "max_line_width"]
    if not args["word_timestamps"]:
        for option in word_options:
            if args[option]:
                parser.error(f"--{option} requires --word_timestamps True")
    if args["max_line_count"] and not args["max_line_width"]:
        warnings.warn("--max_line_count has no effect without --max_line_width")
    writer_args = {arg: args.pop(arg) for arg in word_options}

    model = load_model(model_name, device=resolve_device(device), download_root=model_dir,
                       at_low_compute=at_low_compute, at_checkpoint=at_checkpoint)
    writer = get_writer(output_format, output_dir)
    audio_paths = args.pop("audio")
    if batched:
        args.pop("condition_on_previous_text", None)  # windows decode in parallel
        if len(audio_paths) > 1:
            # the files' windows share the batches
            results = transcribe_many(model, audio_paths, temperature=temperature, **args)
            for audio_path, result in zip(audio_paths, results):
                writer(result, audio_path, writer_args)
            return
        run = transcribe_batched
    else:
        run = transcribe
    for audio_path in audio_paths:
        result = run(model, audio_path, temperature=temperature, **args)
        writer(result, audio_path, writer_args)


if __name__ == "__main__":
    cli()
