"""Merge per-chunk prediction JSONLs (``evaluate --num-chunks``) into one
submission file.  Duplicate qids (overlapping chunks, reruns) keep the
last occurrence, in first-seen order.

    python -m mraudio_tpu_torch.cli.merge_chunks --output P.jsonl C0.jsonl C1.jsonl
"""

from __future__ import annotations

import argparse
import json


def merge(chunk_paths: list[str]) -> list[dict]:
    by_qid: dict = {}
    order: list = []
    for path in chunk_paths:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                record = json.loads(line)
                if record["qid"] not in by_qid:
                    order.append(record["qid"])
                by_qid[record["qid"]] = record
    return [by_qid[qid] for qid in order]


def main(argv=None):
    parser = argparse.ArgumentParser(description="merge chunked predictions")
    parser.add_argument("--output", required=True)
    parser.add_argument("chunks", nargs="+")
    args = parser.parse_args(argv)
    records = merge(args.chunks)
    with open(args.output, "w") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")
    print(f"merged {len(records)} records from {len(args.chunks)} chunks")


if __name__ == "__main__":
    main()
