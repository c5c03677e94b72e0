"""Gradio demo of the PyTorch/CUDA port: speech recognition and audio
tagging in the browser (`app.py` in the port's API).

The handler of the reference's Space app (reference app.py:9-58): a
model-size choice, microphone or file input, the language, and the tagging
time resolution rounded to a multiple of 0.4 s; the output is the ASR
segments with the top-5 sound tags of each. Models are read with
`load_model` from the local checkpoint cache (nothing is downloaded) and
run on the card. gradio is imported only by `main()`.
"""

import whisper_at_tpu_torch as wat

MODEL_SIZES = ["tiny", "base", "small", "large-v1"]
_models = {}


def _get_model(size: str):
    if size not in _models:
        _models[size] = wat.load_model(size)
    return _models[size]


def round_time_res(value: float) -> float:
    """The nearest positive multiple of 0.4 s (10 s for anything unreadable)."""
    try:
        value = float(value)
    except (TypeError, ValueError):
        return 10.0
    return max(0.4, round(value / 0.4) * 0.4)


def predict(audio_path: str, model_size: str, language: str, time_res) -> str:
    model = _get_model(model_size)
    time_res = round_time_res(time_res)
    lang = None if language in (None, "", "auto") else language
    result = wat.transcribe(model, audio_path, at_time_res=time_res, language=lang)
    tags = wat.parse_at_label(result, language="en", top_k=5, p_threshold=-1)

    lines = []
    for segment, tag in zip_segments_tags(result["segments"], tags, time_res):
        lines.append(segment)
        if tag is not None:
            names = ", ".join(name for name, _ in tag["audio tags"])
            lines.append(f"  [sounds: {names}]")
    return "\n".join(lines) if lines else result["text"]


def zip_segments_tags(segments, tags, time_res):
    """(segment line, the tag cell its start falls in or None) a segment."""
    for seg in segments:
        text = f"[{seg['start']:.1f}s -> {seg['end']:.1f}s] {seg['text'].strip()}"
        idx = int(seg["start"] // time_res)
        yield text, tags[idx] if idx < len(tags) else None


def main():
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit(
            "The demo UI requires gradio (`pip install gradio`). The underlying "
            "API is available as whisper_at_tpu_torch.transcribe / parse_at_label.")

    demo = gr.Interface(
        fn=predict,
        inputs=[
            gr.Audio(type="filepath", label="Audio (mic or file)"),
            gr.Radio(MODEL_SIZES, value="base", label="Model size"),
            gr.Textbox(value="auto", label="Language (code or 'auto')"),
            gr.Textbox(value="10", label="Tag time resolution (multiple of 0.4 s)"),
        ],
        outputs=gr.Textbox(label="Transcript + sound tags"),
        title="Whisper-AT (PyTorch/CUDA): joint speech recognition and audio tagging",
    )
    demo.launch()


if __name__ == "__main__":
    main()
