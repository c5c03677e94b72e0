"""One recording a call: `transcribe_batched`, its 30 s windows decoded in
batches of `max_batch`. The window is the closed loop (`generator.closed_loop`)."""


def call(model, files, options):
    import whisper_at_tpu_torch as wat

    if len(files) != 1:
        raise ValueError("transcribe_batched takes one recording a call")
    return [wat.transcribe_batched(model, files[0], **options)]
