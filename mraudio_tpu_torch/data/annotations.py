"""Annotation loading and sharding.

Canonical schema (the JAX package's ``cli/prepare_data`` writes it):

    {"vid": str, "qid": int|str, "query": str, "duration": number,
     "relevant_windows": [[st, ed], ...]}

optionally ``start``/``end`` (sub-clip bounds) and ``objects``
(Charades).
"""

from __future__ import annotations

import json
from typing import Any

REQUIRED_KEYS = ("vid", "qid", "query", "duration", "relevant_windows")


def load_annotations(path: str, validate: bool = True) -> list[dict]:
    """Load a JSONL annotation file."""
    with open(path) as f:
        anns = [json.loads(line) for line in f if line.strip()]
    if validate:
        for i, ann in enumerate(anns):
            missing = [k for k in REQUIRED_KEYS if k not in ann]
            if missing:
                raise ValueError(f"{path}:{i + 1} missing keys {missing}")
    return anns


def save_jsonl(records: list[dict], path: str) -> None:
    with open(path, "w") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")


def chunk_annotations(anns: list[Any], num_chunks: int, chunk_idx: int) -> list[Any]:
    """Shard an annotation list for embarrassingly-parallel eval:
    contiguous near-equal splits covering every record exactly once."""
    if not 0 <= chunk_idx < num_chunks:
        raise ValueError(f"chunk_idx {chunk_idx} out of range for {num_chunks} chunks")
    n = len(anns)
    base, extra = divmod(n, num_chunks)
    start = chunk_idx * base + min(chunk_idx, extra)
    end = start + base + (1 if chunk_idx < extra else 0)
    return anns[start:end]
