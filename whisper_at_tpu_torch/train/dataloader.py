"""Feature dataset and thread-prefetched loader for TL-TR head training.

Counterpart of `whisper_at_tpu/train/dataloader.py`, in numpy and the
standard library, with the same random streams (`default_rng(seed + epoch)`
for an epoch's order, `default_rng((seed, epoch, b))` for batch b's mixup
and masks), so both packages give identical batches. Items are
precomputed encoder-feature files ([n_layer, T, rep_dim], `.npz` arr_0 when
the feature directory's name holds `feat_as`, `feat_esc_pool` or `sonyc`,
else `.npy`) named after the wav's stem; time is padded or cropped to 25
pooled frames; mixup with Beta(10, 10), label smoothing, SpecAug-style
masks on the feature map, class-balanced sampling with replacement. A file
that cannot be read is replaced by zeros, as in the reference, and counted
in `FeatureDataset.missing`.
"""

import csv
import json
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


def make_index_dict(label_csv: str) -> dict:
    """mid -> class index from a class_labels_indices.csv file."""
    index_lookup = {}
    with open(label_csv, "r") as f:
        for row in csv.DictReader(f):
            index_lookup[row["mid"]] = row["index"]
    return index_lookup


def make_name_dict(label_csv: str) -> dict:
    name_lookup = {}
    with open(label_csv, "r") as f:
        for row in csv.DictReader(f):
            name_lookup[row["index"]] = row["display_name"]
    return name_lookup


def _mask_axis(x: np.ndarray, axis: int, max_width: int, rng) -> np.ndarray:
    """torchaudio-style masking: width ~ U[0, max_width), uniform start."""
    size = x.shape[axis]
    width = int(rng.uniform(0.0, max_width))
    width = min(width, size)
    if width == 0:
        return x
    start = int(rng.uniform(0, size - width + 1))
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(start, start + width)
    x[tuple(sl)] = 0.0
    return x


class FeatureDataset:
    """Precomputed-feature dataset over a {'data': [{'wav','labels'}]} json."""

    def __init__(
        self,
        dataset_json_file: str,
        audio_conf: dict,
        label_csv: Optional[str] = None,
        target_time: int = 25,
        missing_shape: Tuple[int, int, int] = (6, 25, 512),
    ):
        with open(dataset_json_file, "r") as fp:
            data_json = json.load(fp)
        # store as a string array to avoid per-item dict overhead
        self.data = np.array(
            [[d["wav"], d["labels"]] for d in data_json["data"]], dtype=str
        )
        self.num_samples = self.data.shape[0]

        self.label_smooth = audio_conf.get("label_smooth", 0.0)
        self.freqm = audio_conf.get("freqm", 0)
        self.timem = audio_conf.get("timem", 0)
        self.mixup = audio_conf.get("mixup", 0)
        self.dataset = audio_conf.get("dataset")
        self.tar_path = audio_conf.get("tar_path")
        self.target_time = target_time
        self.missing_shape = missing_shape

        self.index_dict = make_index_dict(label_csv)
        # features that fell back to zeros (a missing or unreadable file)
        self.missing = 0
        self._missing_lock = threading.Lock()
        self.label_num = len(self.index_dict)

        # feature container format follows the extraction recipe
        self.fmt = ".npz" if any(
            k in (self.tar_path or "")
            for k in ("feat_as", "feat_esc_pool", "sonyc")
        ) else ".npy"

    def __len__(self) -> int:
        return self.num_samples

    def _feature_path(self, wav: str) -> str:
        stem = ".".join(os.path.basename(wav).split(".")[:-1])
        return os.path.join(self.tar_path, stem + self.fmt)

    def _load_features(self, wav: str) -> np.ndarray:
        path = self._feature_path(wav)
        try:
            if path.endswith(".npz"):
                feat = np.load(path)["arr_0"]
            else:
                feat = np.load(path)
        except Exception:
            # missing-file fallback (dataloader_feat.py:97-106)
            print("a missing file", path)
            with self._missing_lock:
                self.missing += 1
            return np.zeros(self.missing_shape, np.float32)
        feat = np.asarray(feat, np.float32)
        t = self.target_time
        if feat.shape[1] < t:
            feat = np.pad(feat, ((0, 0), (0, t - feat.shape[1]), (0, 0)))
        else:
            feat = feat[:, :t, :]
        return feat

    def _labels_to_multihot(self, labels: str, weight: float) -> np.ndarray:
        vec = np.full(
            (self.label_num,), self.label_smooth / self.label_num, np.float32
        )
        for label_str in labels.split(","):
            vec[int(self.index_dict[label_str])] += weight * (1.0 - self.label_smooth)
        return vec

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()

        if rng.random() < self.mixup:
            wav, labels = self.data[index]
            mix_idx = int(rng.integers(0, self.num_samples))
            mix_wav, mix_labels = self.data[mix_idx]
            lam = float(rng.beta(10, 10))
            feat = lam * self._load_features(wav) + (1 - lam) * self._load_features(
                mix_wav
            )
            target = self._labels_to_multihot(labels, lam)
            target += self._labels_to_multihot(mix_labels, 1 - lam) - (
                self.label_smooth / self.label_num
            )
        else:
            wav, labels = self.data[index]
            feat = self._load_features(wav)
            target = np.full(
                (self.label_num,), self.label_smooth / self.label_num, np.float32
            )
            for label_str in labels.split(","):
                target[int(self.index_dict[label_str])] = 1.0 - self.label_smooth

        # SpecAug on the feature map: mask rep-dim ("freq") and time axes
        # (dataloader_feat.py:177-185 transposes to [L, D, T] first)
        if self.freqm != 0:
            feat = _mask_axis(feat, axis=2, max_width=self.freqm, rng=rng)
        if self.timem != 0:
            feat = _mask_axis(feat, axis=1, max_width=self.timem, rng=rng)

        return feat.astype(np.float32), target.astype(np.float32)


def balanced_sample_weights(data_json_path: str, label_csv: str) -> np.ndarray:
    """Per-sample weights = sum over labels of 1000/(class_count + 0.01)
    (whisper_at_train/gen_weight_file.py)."""
    index_dict = make_index_dict(label_csv)
    n_class = len(index_dict)
    with open(data_json_path, "r", encoding="utf8") as fp:
        data = json.load(fp)["data"]

    label_count = np.zeros(n_class)
    for sample in data:
        for label in sample["labels"].split(","):
            label_count[int(index_dict[label])] += 1

    label_weight = 1000.0 / (label_count + 0.01)
    sample_weight = np.zeros(len(data))
    for i, sample in enumerate(data):
        for label in sample["labels"].split(","):
            sample_weight[i] += label_weight[int(index_dict[label])]
    return sample_weight


def gen_weight_file(data_json_path: str, label_csv: str) -> str:
    """Write the *_weight.csv next to the data json (gen_weight_file.py CLI)."""
    weights = balanced_sample_weights(data_json_path, label_csv)
    out_path = data_json_path[:-5] + "_weight.csv"
    np.savetxt(out_path, weights, delimiter=",")
    return out_path


class DataLoader:
    """Thread-prefetched batch iterator over a FeatureDataset.

    sampler_weights enables balanced sampling with replacement; otherwise
    optional shuffling. drop_last mirrors the torch loader used in training.
    """

    def __init__(
        self,
        dataset: FeatureDataset,
        batch_size: int,
        shuffle: bool = False,
        sampler_weights: Optional[np.ndarray] = None,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler_weights = sampler_weights
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, rng) -> np.ndarray:
        n = len(self.dataset)
        if self.sampler_weights is not None:
            p = self.sampler_weights / self.sampler_weights.sum()
            return rng.choice(n, size=n, replace=True, p=p)
        idx = np.arange(n)
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        indices = self._epoch_indices(rng)
        n_batches = len(self)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def producer():
            # workers pull batch indices from a shared counter, posting
            # (batch_idx, data) so the consumer can reassemble in order
            def load_batch(b):
                batch_rng = np.random.default_rng((self.seed, self._epoch, b))
                rows = indices[b * self.batch_size : (b + 1) * self.batch_size]
                feats, targets = [], []
                for i in rows:
                    f, t = self.dataset.__getitem__(int(i), rng=batch_rng)
                    feats.append(f)
                    targets.append(t)
                return np.stack(feats), np.stack(targets)

            threads = []
            lock = threading.Lock()
            counter = {"next": 0}

            def worker():
                while True:
                    with lock:
                        b = counter["next"]
                        if b >= n_batches:
                            return
                        counter["next"] = b + 1
                    out_q.put((b, load_batch(b)))

            for _ in range(self.num_workers):
                t = threading.Thread(target=worker, daemon=True)
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
            out_q.put((None, None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        # reassemble in order (batches may complete out of order)
        pending = {}
        expected = 0
        while expected < n_batches:
            b, data = out_q.get()
            if b is None:
                break
            pending[b] = data
            while expected in pending:
                yield pending.pop(expected)
                expected += 1
