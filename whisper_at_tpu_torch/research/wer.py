"""Word error rate scoring for the noise-robustness experiments.

Counterpart of `whisper_at_tpu/research/wer.py`, which replaces the
reference's editdistance and jiwer (noise_robust_asr/asr_experiments/
compute_wer.py:21-70) with a Levenshtein distance over words and the same
text preprocessing (upper case, punctuation stripped). Pure Python and
numpy.
"""

import os
import string
from typing import Dict, List, Sequence

import numpy as np

SNR_LEVELS = [-20, -15, -10, -5, 0, 5, 10, 15, 20]

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def remove_punctuation(text: str) -> str:
    return text.translate(_PUNCT_TABLE)


def preprocess_text(text: str) -> str:
    """jiwer's ToUpperCase then RemovePunctuation."""
    return remove_punctuation(text.upper())


def word_edit_distance(hyp: Sequence[str], ref: Sequence[str]) -> int:
    """Levenshtein distance between two word sequences: one DP row at a
    time, substitutions and deletions as vectors, insertions in order."""
    n, m = len(hyp), len(ref)
    if n == 0:
        return m
    if m == 0:
        return n
    ref_arr = np.asarray(ref, dtype=object)
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        sub_cost = (ref_arr != hyp[i - 1]).astype(np.int64)
        np.minimum(prev[1:] + 1, prev[:-1] + sub_cost, out=cur[1:])
        for j in range(1, m + 1):
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[m])


def calculate_wer(hypotheses: List[str], references: List[str]) -> float:
    """Corpus WER: the word edits of all pairs over all reference words."""
    word_eds, word_ref_lens = [], []
    for hyp_text, ref_text in zip(hypotheses, references):
        hyp_words = hyp_text.split()
        ref_words = ref_text.split()
        word_eds.append(word_edit_distance(hyp_words, ref_words))
        word_ref_lens.append(len(ref_words))
    return float(sum(word_eds)) / sum(word_ref_lens)


def _transcripts(trans_dir: str) -> List[str]:
    return [os.path.join(root, f) for root, _, files in os.walk(trans_dir)
            for f in files if f.endswith(".txt")]


def _pair(trans_name: str, truth_dir: str):
    """(hypothesis, reference) of one '<db>_<class>_<utt>_mix_<noise>.txt'
    transcript, both preprocessed."""
    with open(trans_name, "r") as f:
        hyp = preprocess_text(f.read())
    utt = os.path.basename(trans_name).split("_mix_")[0].split("_")[2]
    with open(os.path.join(truth_dir, utt + ".txt"), "r") as f:
        return hyp, preprocess_text(f.read())


def eval_noise_wer(
    trans_dir: str,
    truth_dir: str,
    result_path: str,
    snr_levels: Sequence[int] = tuple(SNR_LEVELS),
) -> Dict[int, float]:
    """WER per SNR over a directory of transcripts named
    '<db>_<class>_<utt>_mix_<noise>.txt'; the list so far is written to
    `result_path` as csv after each SNR."""
    transcripts = _transcripts(trans_dir)
    wer_by_snr = {}
    wer_list = []
    for db in snr_levels:
        pairs = [_pair(t, truth_dir) for t in transcripts
                 if int(os.path.basename(t).split("_")[0]) == db]
        wer = calculate_wer([h for h, _ in pairs], [r for _, r in pairs])
        wer_by_snr[db] = wer
        wer_list.append(wer)
        np.savetxt(result_path, wer_list, delimiter=",")
    return wer_by_snr


def eval_noise_wer_classwise(
    trans_dir: str,
    truth_dir: str,
    result_path: str,
    n_classes: int = 50,
    snr_levels: Sequence[int] = tuple(SNR_LEVELS),
) -> np.ndarray:
    """WER per (SNR, noise class): [n_snr, n_classes], NaN where a class has
    no transcript at that SNR; also written to `result_path` as csv."""
    transcripts = _transcripts(trans_dir)
    wer = np.full((len(snr_levels), n_classes), np.nan)
    for si, db in enumerate(snr_levels):
        buckets: Dict[int, Dict[str, List[str]]] = {}
        for trans_name in transcripts:
            parts = os.path.basename(trans_name).split("_")
            if int(parts[0]) != db:
                continue
            hyp, ref = _pair(trans_name, truth_dir)
            bucket = buckets.setdefault(int(parts[1]), {"hyp": [], "ref": []})
            bucket["hyp"].append(hyp)
            bucket["ref"].append(ref)
        for cla, bucket in buckets.items():
            wer[si, cla] = calculate_wer(bucket["hyp"], bucket["ref"])
    np.savetxt(result_path, wer, delimiter=",")
    return wer
