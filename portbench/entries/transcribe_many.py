"""Many files a call: `transcribe_many`, the serving entry's batched
frontend and decode over every file's windows. The window is the closed
loop (`generator.closed_loop`)."""


def call(model, files, options):
    import whisper_at_tpu_torch as wat

    return wat.transcribe_many(model, files, **options)
