"""Append-only JSONL journal for crash-consistent replay.

Port of ``repro.checkpoint.journal``, with its schema: one JSON object a
line, flushed per entry, arrays inline as ``{"b64", "dtype", "shape"}``
triples, so either package replays the other's journal.

The continuous-ingest service logs every state-mutating operation
(admitted offer, refusal, tick, merge, migration op) as one line. A
recovery loads the latest snapshot and replays the journal tail through
the NORMAL code paths, so the rebuilt state is the product of the same
deterministic machinery that produced the original.

The port's packed words are int32 tensors carrying the uint32 bit
pattern; the reference's are uint32. A word stream is journaled as
``uint32`` (:func:`encode_words`) and read back as int32, bit for bit
(:func:`decode_words`).
"""
from __future__ import annotations

import base64
import json
import os
from typing import Iterator

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def encode_array(a) -> dict:
    """numpy array or tensor -> JSON-able {b64, dtype, shape} triple."""
    a = _host(a)
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def decode_array(d: dict) -> np.ndarray:
    """Inverse of :func:`encode_array` (bit-exact)."""
    return np.frombuffer(base64.b64decode(d["b64"]),
                         dtype=np.dtype(d["dtype"])
                         ).reshape(d["shape"]).copy()


def encode_words(words) -> dict:
    """A packed word stream (int32 or uint32) -> the triple of its uint32
    bit pattern, as the reference journals its words."""
    return encode_array(_host(words).view(np.uint32))


def decode_words(d: dict) -> np.ndarray:
    """A journaled word stream -> int32 words carrying the same bits."""
    return np.ascontiguousarray(decode_array(d)).view(np.int32)


class Journal:
    """One append-only JSONL file of replayable operations.

    ``position`` counts entries ever appended (the snapshot high-water
    mark); ``resume=True`` reopens an existing journal for appending
    (recovery keeps journaling where the crashed process stopped).
    Every ``append`` flushes: a killed process loses at most the entry
    it was mid-writing, and :meth:`entries` skips a torn final line.
    """

    def __init__(self, path: str, *, resume: bool = False):
        self.path = path
        self.position = 0
        if resume and os.path.exists(path):
            self.position = sum(1 for _ in self._read())
            self._fh = open(path, "a")
        else:
            self._fh = open(path, "w")

    def append(self, entry: dict) -> int:
        """Write one entry; returns its index in the journal."""
        self._fh.write(json.dumps(entry) + "\n")
        self._fh.flush()
        idx, self.position = self.position, self.position + 1
        return idx

    def _read(self) -> Iterator[dict]:
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    return          # torn tail from a mid-write kill

    def entries(self, start: int = 0) -> Iterator[dict]:
        """Yield entries from index ``start`` (the replay tail)."""
        for i, entry in enumerate(self._read()):
            if i >= start:
                yield entry

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
