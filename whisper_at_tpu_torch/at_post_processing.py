"""Audio-tag post-processing: tag logits -> per-segment label lists, with
label names in any of the languages of the shipped label table."""

import json
import os
import warnings
from functools import lru_cache

import numpy as np

from .tokenizer import ASSETS


@lru_cache(maxsize=1)
def _label_names() -> dict:
    with open(os.path.join(ASSETS, "label_name_dict.json")) as f:
        return json.load(f)


def parse_at_label(result: dict, language: str = "follow_asr", top_k: int = 5,
                   p_threshold: float = -1, include_class_list=None):
    """[{'time': {'start', 'end'}, 'audio tags': [(name, logit), ...]}] per
    tagging cell: the top_k classes above p_threshold, restricted to
    include_class_list (all 527 by default)."""
    include = set(range(527) if include_class_list is None else include_class_list)
    res = result["at_time_res"]
    tags = np.asarray(result["audio_tag"], dtype=np.float32)
    if language == "follow_asr":
        language = result["language"]
    names = _label_names()
    if language not in names:
        warnings.warn(f"{language} language not supported. Use English label names "
                      "instead. If you wish to use label names of a specific language, "
                      "please specify the language argument")
        language = "en"
    labels = names[language]
    out = []
    for i, row in enumerate(tags):
        top = np.argsort(row)[::-1][:top_k]
        kept = [(labels[int(j)], float(row[j])) for j in top
                if row[j] > p_threshold and int(j) in include]
        out.append({"time": {"start": i * res, "end": (i + 1) * res}, "audio tags": kept})
    return out
