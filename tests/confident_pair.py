"""A small JAX model and its port (2 layers, width 64, a 64-token text
context) whose decoder is sure of itself, for the tests that run the
sequential `transcribe` with its quality gates on in both packages.

The token embedding is scaled x20, so greedy text passes the
log-probability gate, and the no-speech row is set along the SOT
position's input, so the no-speech probability is ~1: the gate then keeps
the temperature-0 decode, text and all, and neither package samples (the
two draw from different generators). The port's weights are carried across
with `convert.from_jax_params`.
"""

import numpy as np

from whisper_at_tpu.models.dims import ModelDimensions as JaxDims
from whisper_at_tpu.models.whisper import Whisper as JaxWhisper
from whisper_at_tpu_torch.convert import from_jax_params
from whisper_at_tpu_torch.models.dims import ModelDimensions
from whisper_at_tpu_torch.models.whisper import Whisper
from whisper_at_tpu_torch.tokenizer import get_tokenizer

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=64, n_text_head=2,
            n_text_state=64, n_text_layer=2)


def confident_models(seed: int = 2):
    """(JAX model, port model) with the same confident weights, fp32."""
    jm = JaxWhisper(JaxDims(**DIMS), seed=seed)
    tok = get_tokenizer(True)
    dec = dict(jm.params["decoder"])
    emb = np.asarray(dec["token_embedding"], np.float32)
    d = emb[tok.sot] + np.asarray(dec["positional_embedding"], np.float32)[0]
    emb = emb * 20.0
    emb[tok.no_speech] = 10.0 * d / np.linalg.norm(d)
    dec["token_embedding"] = emb
    jm = JaxWhisper(JaxDims(**DIMS), params=dict(jm.params, decoder=dec))
    tm = Whisper(ModelDimensions(**DIMS))
    tm.load_state_dict(from_jax_params(jm.params))
    return jm, tm.eval()
