"""All-layer encoder feature extraction for TL-TR training.

Counterpart of `whisper_at_tpu/research/feature_extract.py`: the mel is
truncated (not padded) to 10 s (1000 frames, AudioSet) or 5 s (500,
ESC-50), the encoder runs with the positional embedding cut to match
(`models.encoder.encoder_apply_taps`), every layer's output is averaged 20x
over time, the embedding tap is dropped, and each clip is saved as one
compressed `.npz` ([n_layer, T/20, D], fp32).

Clips go through the encoder in batches, on K1 (or K7) and K2 as chosen by
WHISPER_AT_TPU_ENC_ATTN / WHISPER_AT_TPU_ENC_MLP, read per call as
`Whisper.embed_audio` reads them. Equal-length clips share one batched mel
(`ops.mel.log_mel_batched`). The pooling and the embedding-tap drop run on
the model's device before the copy to the host (in bf16 for a bf16
forward). `extract_feature_set` skips clips whose file exists, and copies a
batch's features to pinned memory behind its encoder work, so the next
batch's encoder runs while this batch's files are written. The files are
compressed on WRITE_THREADS threads (zlib releases the interpreter lock):
on one thread their compression takes far longer than the encoder (see
PERF.md, the training path's findings).
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..audio import N_FRAMES, load_audio_pcm16, log_mel_spectrogram, pad_or_trim
from ..models.encoder import encoder_apply_taps
from ..ops.mel import HOP_LENGTH, log_mel_batched, stft_host_prep
from ..utils import resolve_device

POOL = 20
WRITE_THREADS = min(8, os.cpu_count() or 1)


def _impls() -> dict:
    return dict(attn_impl=os.environ.get("WHISPER_AT_TPU_ENC_ATTN", "single"),
                mlp_impl=os.environ.get("WHISPER_AT_TPU_ENC_MLP", "fused"))


def _taps(model, mel: torch.Tensor, fp16: bool) -> torch.Tensor:
    return encoder_apply_taps(model.encoder, mel, model.audio_heads, "all_nopool",
                              model.compute_dtype(fp16), **_impls())


def extract_features(model, audio, n_frames: int = 1000, pool: int = POOL,
                     drop_embedding_layer: bool = True, fp16: bool = True) -> np.ndarray:
    """One clip -> [n_layer, n_frames / 2 / pool, D] pooled all-layer stack
    (n_frames: 1000 = 10 s AudioSet, 500 = 5 s ESC-50)."""
    dev = resolve_device(model.device)
    mel = pad_or_trim(log_mel_spectrogram(audio, device=dev), n_frames)
    with torch.no_grad():
        taps = _taps(model, mel[None], fp16)[0].float().cpu().numpy()  # [L+1, T', D]
    n_layers, t, d = taps.shape
    pooled = taps[:, : (t // pool) * pool].reshape(n_layers, t // pool, pool, d).mean(axis=2)
    return pooled[1:] if drop_embedding_layer else pooled


def extract_features_padded(model, audio, n_tokens: int = 500, pool: int = POOL,
                            fp16: bool = True) -> np.ndarray:
    """SONYC-style extraction (script/extract_sonyc_features.py:40-100):
    the clip padded to the 30 s window, the full positional embedding, the
    first n_tokens positions (500 = 10 s) kept, then pooled 20x."""
    dev = resolve_device(model.device)
    mel = pad_or_trim(log_mel_spectrogram(audio, device=dev), N_FRAMES)
    with torch.no_grad():
        taps = _taps(model, mel[None], fp16)[0].float().cpu().numpy()
    taps = taps[1:, :n_tokens]  # drop the embedding tap
    n_layers, t, d = taps.shape
    return taps.reshape(n_layers, t // pool, pool, d).mean(axis=2)


def _pool_taps_device(taps: torch.Tensor, pool: int) -> torch.Tensor:
    """[B, L+1, T', D] taps -> fp32 [B, L, T'//pool, D] on their device: the
    20x pooling over the first (T' // pool) * pool positions and the
    embedding-tap drop, before the copy to the host."""
    b, n_layers, t, d = taps.shape
    t_used = (t // pool) * pool
    pooled = taps[:, 1:, :t_used].float().reshape(b, n_layers - 1, t // pool, pool, d)
    return pooled.mean(dim=3)


def _mel_batch_for_clips(audios, n_frames: int, device: torch.device) -> torch.Tensor:
    """[N, 80, n_frames] mels of a list of clips, each the clip's own mel
    truncated or zero-padded to n_frames: one batched mel when every clip
    has the same length and sample type (the AudioSet protocol, all 10 s),
    else one mel a clip."""
    arrs = [np.asarray(a).reshape(-1) for a in audios]
    if len({a.shape[0] for a in arrs}) == 1:
        preps = [stft_host_prep(a, 0) for a in arrs]
        if len({p[0].dtype for p in preps}) == 1:
            sigs = torch.from_numpy(np.stack([p[0] for p in preps])).to(device)
            n_valid = torch.tensor([p[1] for p in preps], device=device)
            logs = log_mel_batched(sigs, n_valid, sigs.shape[1] // HOP_LENGTH - 2)
            return pad_or_trim(logs.transpose(1, 2), n_frames)
    mels = [pad_or_trim(log_mel_spectrogram(a, device=device), n_frames) for a in arrs]
    return torch.stack(mels)


def extract_features_many(model, audios, n_frames: int = 1000, pool: int = POOL,
                          fp16: bool = True, fetch_dtype=None) -> torch.Tensor:
    """`extract_features` for a list of clips in one encoder forward: a
    device tensor [B, n_layer, n_frames / 2 / pool, D], embedding tap
    dropped. fetch_dtype: its dtype (None keeps the fp32 means; bf16 halves
    the copy to the host for values already of bf16 precision)."""
    dev = resolve_device(model.device)
    with torch.no_grad():
        mel = _mel_batch_for_clips(audios, n_frames, dev)
        pooled = _pool_taps_device(_taps(model, mel, fp16), pool)
    return pooled if fetch_dtype is None else pooled.to(fetch_dtype)


def _to_host(dev_out: torch.Tensor):
    """Start the copy of `dev_out` to the host; returns (tensor, event)."""
    if not dev_out.is_cuda:
        return dev_out, None
    host = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
    host.copy_(dev_out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _save_chunk(paths: List[str], pooled: np.ndarray) -> None:
    """One `np.savez_compressed` a clip (the features as `arr_0`), on up to
    WRITE_THREADS threads."""
    with ThreadPoolExecutor(max_workers=max(1, min(WRITE_THREADS, len(paths)))) as pool:
        list(pool.map(np.savez_compressed, paths, pooled))


def extract_feature_set(model, dataset_json_file: str, tar_path: str, n_frames: int = 1000,
                        batch_size: int = 8, fp16: bool = True,
                        limit: Optional[int] = None) -> List[str]:
    """Extraction over a {'data': [{'wav': ...}]} json into `tar_path`, one
    `<wav stem>.npz` a clip, skipping clips whose file exists
    (extract_as_full_whisper_all.py:33). Returns the paths written."""
    dev = resolve_device(model.device)
    os.makedirs(tar_path, exist_ok=True)
    with open(dataset_json_file, "r") as fp:
        data = json.load(fp)["data"]
    if limit is not None:
        data = data[:limit]

    def out_path(wav: str) -> str:
        stem = os.path.splitext(os.path.basename(wav))[0]
        return os.path.join(tar_path, stem + ".npz")

    todo = [e["wav"] for e in data if not os.path.exists(out_path(e["wav"]))]
    written = []
    fetch_dtype = torch.bfloat16 if fp16 else None
    chunks = [todo[s:s + batch_size] for s in range(0, len(todo), batch_size)]
    pending = None  # (chunk, host tensor, copy event)
    for chunk in chunks + [None]:
        nxt = None
        if chunk is not None:
            feats = extract_features_many(model, [load_audio_pcm16(w) for w in chunk],
                                          n_frames, fp16=fp16, fetch_dtype=fetch_dtype)
            nxt = (chunk, *_to_host(feats))
        if pending is not None:
            prev_chunk, host, event = pending
            if event is not None:
                event.synchronize()
            paths = [out_path(wav) for wav in prev_chunk]
            _save_chunk(paths, host.float().numpy())
            written += paths
        pending = nxt
    return written
