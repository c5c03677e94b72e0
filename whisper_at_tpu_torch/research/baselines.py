"""wav2vec2 / HuBERT baseline runners for the noise-robustness comparison.

Counterpart of `whisper_at_tpu/research/baselines.py` (the reference's
noise_robust_asr/asr_experiments/transcribe_{w2v,hubert}*.py and the SSL
feature extractors of intermediate_feat_extract/{w2v,hubert}), over
Hugging Face `transformers`, imported inside the functions. The runners
take `device` (the card unless the caller asks for the CPU) and move the
model there. Released weights are read only from the local Hugging Face
cache (`local_files_only=True`): nothing is fetched. `build_local_ctc` and
`build_local_ssl` build random-weight models of the same architecture from
a seed, so the experiment loop (mix, transcribe, WER) runs without them.
"""

import json
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio import load_audio
from ..utils import resolve_device

BASELINE_MODELS = {
    "wav2vec2-base": "facebook/wav2vec2-base-960h",
    "wav2vec2-robust": "facebook/wav2vec2-large-robust-ft-swbd-300h",
    "hubert-large": "facebook/hubert-large-ls960-ft",
    "hubert-xlarge": "facebook/hubert-xlarge-ls960-ft",
}

# the released wav2vec2 / HuBERT CTC characters (letters, the word boundary
# '|' and the apostrophe), enough to score English text
_CTC_VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|", "'"] + [
    chr(c) for c in range(ord("A"), ord("Z") + 1)
]


def _local_processor():
    from transformers import Wav2Vec2CTCTokenizer, Wav2Vec2FeatureExtractor, Wav2Vec2Processor

    with tempfile.TemporaryDirectory() as td:
        vocab_path = os.path.join(td, "vocab.json")
        with open(vocab_path, "w") as f:
            json.dump({tok: i for i, tok in enumerate(_CTC_VOCAB)}, f)
        tokenizer = Wav2Vec2CTCTokenizer(vocab_path, unk_token="<unk>", pad_token="<pad>",
                                         word_delimiter_token="|")
    feature_extractor = Wav2Vec2FeatureExtractor(
        feature_size=1, sampling_rate=16000, padding_value=0.0, do_normalize=True,
        return_attention_mask=False)
    return Wav2Vec2Processor(feature_extractor=feature_extractor, tokenizer=tokenizer)


def _tiny_w2v_config(**overrides):
    from transformers import Wav2Vec2Config

    cfg = dict(vocab_size=len(_CTC_VOCAB), hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64, conv_dim=(32, 32),
               conv_stride=(5, 4), conv_kernel=(10, 3), num_feat_extract_layers=2,
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    cfg.update(overrides)
    return Wav2Vec2Config(**cfg)


def build_local_ctc(seed: int = 0, **config_overrides):
    """(processor, model): a tiny random-weight wav2vec2 CTC model from
    `seed`, built without any download, on the CPU."""
    from transformers import Wav2Vec2ForCTC

    torch.manual_seed(seed)
    model = Wav2Vec2ForCTC(_tiny_w2v_config(**config_overrides))
    model.eval()
    return _local_processor(), model


def build_local_ssl(seed: int = 0, **config_overrides):
    """(processor, model): a tiny random-weight wav2vec2 encoder with its
    hidden states on, from `seed`, for `extract_ssl_features`."""
    from transformers import Wav2Vec2Model

    torch.manual_seed(seed)
    model = Wav2Vec2Model(_tiny_w2v_config(output_hidden_states=True, **config_overrides))
    model.eval()
    return _local_processor(), model


def _load_ctc(model_name: str):
    """A released CTC model and its processor from the local cache only."""
    try:
        from transformers import AutoModelForCTC, AutoProcessor
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("transformers is required for the baselines") from e
    repo = BASELINE_MODELS.get(model_name, model_name)
    processor = AutoProcessor.from_pretrained(repo, local_files_only=True)
    model = AutoModelForCTC.from_pretrained(repo, local_files_only=True)
    model.eval()
    return processor, model


def transcribe_ctc(
    model_name: str,
    audio_paths: List[str],
    text_dir: str,
    processor_model: Optional[Tuple] = None,
    device="cuda",
) -> List[str]:
    """Greedy CTC transcription of each file into `text_dir/<name>.txt` on
    `device`; a transcript that exists is skipped. Returns the files
    written."""
    dev = resolve_device(device)
    processor, model = processor_model or _load_ctc(model_name)
    model.to(dev)
    os.makedirs(text_dir, exist_ok=True)
    outputs = []
    for path in audio_paths:
        out_path = os.path.join(text_dir, os.path.splitext(os.path.basename(path))[0] + ".txt")
        if os.path.exists(out_path):
            continue
        inputs = processor(load_audio(path), sampling_rate=16000, return_tensors="pt")
        with torch.no_grad():
            logits = model(inputs.input_values.to(dev)).logits
        text = processor.batch_decode(torch.argmax(logits, dim=-1).cpu())[0]
        with open(out_path, "w") as f:
            f.write(text)
        outputs.append(out_path)
    return outputs


def extract_ssl_features(
    model_name: str,
    audio,
    pool: Optional[int] = 20,
    processor_model: Optional[Tuple] = None,
    device="cuda",
) -> np.ndarray:
    """Every hidden state of a wav2vec2 / HuBERT model, the embedding
    output included, [L+1, T, D], averaged over `pool` frames when given
    (the SSL counterpart of the Whisper all-layer taps)."""
    dev = resolve_device(device)
    if processor_model is not None:
        processor, model = processor_model
    else:
        from transformers import AutoModel, AutoProcessor

        repo = BASELINE_MODELS.get(model_name, model_name)
        processor = AutoProcessor.from_pretrained(repo, local_files_only=True)
        model = AutoModel.from_pretrained(repo, output_hidden_states=True,
                                          local_files_only=True)
        model.eval()
    model.to(dev)
    if isinstance(audio, str):
        audio = load_audio(audio)
    inputs = processor(audio, sampling_rate=16000, return_tensors="pt")
    with torch.no_grad():
        out = model(inputs.input_values.to(dev))
    taps = torch.stack(out.hidden_states, dim=0)[:, 0].cpu().numpy()  # [L+1, T, D]
    if pool:
        n_layers, t, d = taps.shape
        taps = taps[:, : (t // pool) * pool].reshape(n_layers, t // pool, pool, d).mean(axis=2)
    return taps
