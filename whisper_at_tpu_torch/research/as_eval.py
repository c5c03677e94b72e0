"""AudioSet evaluation through the whole inference path.

Counterpart of `whisper_at_tpu/research/as_eval.py` (the reference's
whisper_at_train/utilities/whisper_at_as_eval.py:1-76 and compute_mAP.py:
1-37): each eval clip goes through the sequential `transcribe` with the
quality gates off, the first 30 s window's tag logits are the clip's
prediction, the predictions and targets are saved, and mAP is computed from
them (`train.stats`), also later from the saved arrays.
"""

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..train.dataloader import make_index_dict
from ..train.stats import calculate_stats, mean_average_precision


def evaluate_audioset(
    model,
    eval_json: str,
    label_csv: str,
    out_dir: str,
    tag: str = "model",
    limit: Optional[int] = None,
    at_time_res: float = 10,
) -> Dict[str, float]:
    """Transcribe and tag each clip of `eval_json` (the first `limit`);
    saves `<tag>_pred.npy` and `<tag>_truth.npy` [clips, classes] in
    `out_dir` and returns {"mAP": ...}."""
    os.makedirs(out_dir, exist_ok=True)
    index_dict = make_index_dict(label_csv)
    n_class = len(index_dict)
    with open(eval_json, "r") as fp:
        data = json.load(fp)["data"]
    if limit is not None:
        data = data[:limit]

    preds, truths = [], []
    for entry in data:
        result = model.transcribe(entry["wav"], at_time_res=at_time_res,
                                  logprob_threshold=None, compression_ratio_threshold=None,
                                  verbose=None)
        preds.append(np.asarray(result["audio_tag"])[0])  # the first 30 s window
        truth = np.zeros(n_class, np.float32)
        for label in entry["labels"].split(","):
            truth[int(index_dict[label])] = 1.0
        truths.append(truth)

    preds = np.stack(preds)
    truths = np.stack(truths)
    np.save(os.path.join(out_dir, f"{tag}_pred.npy"), preds)
    np.save(os.path.join(out_dir, f"{tag}_truth.npy"), truths)
    return {"mAP": mean_average_precision(calculate_stats(preds, truths))}


def compute_map_from_saved(out_dir: str, tags: List[str]) -> Dict[str, float]:
    """mAP of each tag's saved predictions and targets, printed and returned."""
    results = {}
    for tag in tags:
        preds = np.load(os.path.join(out_dir, f"{tag}_pred.npy"))
        truths = np.load(os.path.join(out_dir, f"{tag}_truth.npy"))
        results[tag] = mean_average_precision(calculate_stats(preds, truths))
        print("{:s} mAP: {:.4f}".format(tag, results[tag]))
    return results
