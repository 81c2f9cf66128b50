"""Training data: a JSONL manifest -> codec-encoded continuation grids ->
length-bucketed, left-padded, prefetched batches.

Ports ``mosstts_tpu/train/data.py`` (``load_manifest``, ``TTSDataset``,
``BucketedLoader``) over the port's processor and codec: the same rows give
the same batches. Sequence lengths round up to a bucket (few distinct
shapes per run); a background thread tokenizes, encodes and packs the next
batches into a bounded queue while a step runs; labels are -100 over the
prompt (everything through the last ``<|im_start|>`` + 2, the engines'
start slicing) and over padding, so the loss trains the assistant's text
and audio positions only.

Manifest format: JSONL rows {"text": ..., "audio": "path.wav"}, the audio
path relative to the manifest's directory.
"""
from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_manifest(path: str | Path) -> List[Dict]:
    """JSONL rows with absolute-ized audio paths."""
    path = Path(path)
    rows = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        if "audio" in row and not Path(row["audio"]).is_absolute():
            row["audio"] = str(path.parent / row["audio"])
        rows.append(row)
    return rows


class TTSDataset:
    """Rows -> (T, C) continuation grids + label masks, via the family
    processor and an audio tokenizer (codec)."""

    def __init__(self, rows: Sequence[Dict], processor, codec,
                 n_vq: Optional[int] = None):
        self.rows = list(rows)
        self.proc = processor
        self.codec = codec
        self.n_vq = n_vq

    def __len__(self) -> int:
        return len(self.rows)

    def example(self, i: int) -> Dict[str, np.ndarray]:
        row = self.rows[i]
        codes = self.proc.encode_audios_from_path(
            [row["audio"]], n_vq=self.n_vq)[0]
        conv = [
            self.proc.build_user_message(text=row["text"]),
            self.proc.build_assistant_message([codes]),
        ]
        batch = self.proc([conv], mode="continuation", n_vq=self.n_vq)
        ids = np.asarray(batch["input_ids"][0])
        mask = np.asarray(batch["attention_mask"][0], bool)
        ids = ids[mask]  # strip the processor's own padding

        # label boundary: same rule the serving engines slice outputs by
        cfg = self.proc.config
        im = np.nonzero(ids[:, 0] == cfg.im_start_token_id)[0]
        start = int(im[-1]) + 3 if len(im) else 0
        labels = np.full_like(ids, -100)
        labels[start:] = ids[start:]
        # the delay ramp fills audio channels with the pad code, whose
        # logit the model masks to -inf (models/delay.py NEG_INF) — a pad
        # label would make the CE infinite, so pads never train
        labels[..., 1:][labels[..., 1:] == cfg.audio_pad_code] = -100
        return {"input_ids": ids, "labels": labels}


class BucketedLoader:
    """Length-bucketed, padded, background-prefetched batch iterator.

    Yields {"input_ids", "attention_mask", "labels"} shaped
    (batch, bucketed_T, C) with LEFT padding (the models' convention) —
    ready for ``TTSTrainer.train_step``.
    """

    def __init__(self, dataset: TTSDataset, *, batch_size: int = 8,
                 bucket: int = 64, max_len: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, pad_token_id: Optional[int] = None,
                 audio_pad_code: Optional[int] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.bucket = bucket
        self.max_len = max_len
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        cfg = dataset.proc.config
        self.pad_token_id = (pad_token_id if pad_token_id is not None
                             else cfg.pad_token_id)
        self.audio_pad_code = (audio_pad_code if audio_pad_code is not None
                               else cfg.audio_pad_code)

    # ------------------------------------------------------------------
    def _pack(self, examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        T = _round_up(max(e["input_ids"].shape[0] for e in examples),
                      self.bucket)
        B = len(examples)
        C = examples[0]["input_ids"].shape[1]
        ids = np.full((B, T, C), self.audio_pad_code, np.int64)
        ids[..., 0] = self.pad_token_id
        labels = np.full((B, T, C), -100, np.int64)
        mask = np.zeros((B, T), bool)
        for b, e in enumerate(examples):
            t = e["input_ids"].shape[0]
            ids[b, T - t:] = e["input_ids"]
            labels[b, T - t:] = e["labels"]
            mask[b, T - t:] = True
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}

    def _epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        # group by bucketed length so batches pad minimally
        examples = []
        for i in order:
            e = self.ds.example(int(i))
            if self.max_len and e["input_ids"].shape[0] > self.max_len:
                e = {k: v[-self.max_len:] for k, v in e.items()}
            examples.append(e)
        examples.sort(key=lambda e: _round_up(e["input_ids"].shape[0],
                                              self.bucket))
        for s in range(0, len(examples), self.batch_size):
            group = examples[s: s + self.batch_size]
            yield self._pack(group)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epochs, produced on a daemon thread into a bounded
        queue — batch k+1 is tokenized/encoded while batch k trains."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # bound locally: at interpreter shutdown the module globals are
        # cleared before generator finalizers run, and `queue.Empty` would
        # no longer resolve to an exception class
        empty_exc = queue.Empty

        def producer():
            epoch = 0
            while not stop.is_set():
                for batch in self._epoch_batches(epoch):
                    if stop.is_set():
                        return
                    q.put(batch)
                epoch += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            # drain so the producer's blocked put() can observe stop
            try:
                while True:
                    q.get_nowait()
            except empty_exc:
                pass
            # let the producer finish its in-flight example: a daemon thread
            # killed inside a codec call can abort the process at exit
            t.join(timeout=60)
