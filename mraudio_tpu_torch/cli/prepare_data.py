"""Offline dataset preparation CLI (the JAX package's
``cli/prepare_data.py``: the reference's ``data/data_preprocess.ipynb``
as a command).

Writes canonical JSONL annotations ``{vid, qid, query, duration,
relevant_windows}`` for:

* ``charades_sta`` — ``id start end##query`` lines with durations from
  the Charades CSV, and optionally the seeded 800-video validation split
  carved from train (``random.seed(42)``, the JAX package's split);
* ``tacos`` — windows and durations rounded as the notebook does;
* ``activitynet`` — the captions JSON, one record per sentence;
* ``activitynet_tal`` — one record per video with ``[start, end, label]``
  triples, split by subset, and the class list;
* ``transcode`` — every video of a folder to a downscaled mp4 through
  the native library (``data/native_bindings.py::transcode``; libav).

Every converter takes the notebook's window encodings: absolute or
relative (``--relative-time``) times, integers or floats
(``--save-float``).  On the same input files the output is the JAX
package's, byte for byte.

    python -m mraudio_tpu_torch.cli.prepare_data tacos --input T.jsonl --output O.jsonl
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random

from mraudio_tpu_torch.data.annotations import save_jsonl


def _encode_window(start: float, end: float, duration: float,
                   relative_time: bool, save_float: bool):
    if relative_time:
        start, end = start / duration, end / duration
        if save_float:
            window = [round(start, 2), round(end, 2)]
            hi = 1
        else:
            window = [int(round(start, 2) * 100), int(round(end, 2) * 100)]
            hi = 100
        if not (0 <= window[0] and window[1] <= hi):
            raise ValueError(f"window {window} outside [0, {hi}] of duration {duration}")
        return window, duration
    if save_float:
        return [float(start), float(end)], duration
    return [round(float(start)), round(float(end))], round(float(duration))


def convert_charades_sta(
    txt_path: str,
    csv_path: str,
    video_ids: set | None = None,
    relative_time: bool = False,
    save_float: bool = False,
) -> list[dict]:
    """``id start end##query`` lines and the Charades CSV (its ``length``
    column) → records; end times clamp to the duration."""
    meta = {}
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            objects = row.get("objects", "") or ""
            meta[row["id"]] = {
                "duration": float(row["length"]),
                "objects": objects.split(";") if objects else [],
            }

    out = []
    with open(txt_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            head, query = line.split("##", 1)
            vid, start, end = head.split(" ")
            if video_ids is not None and vid not in video_ids:
                continue
            duration = meta[vid]["duration"]
            start, end = float(start), min(float(end), duration)
            window, duration_out = _encode_window(
                start, end, duration, relative_time, save_float
            )
            out.append(
                {
                    "vid": vid,
                    "qid": vid,
                    "query": query,
                    "duration": duration_out,
                    "relevant_windows": [window],
                    "objects": meta[vid]["objects"],
                }
            )
    return out


def charades_val_split(txt_path: str, seed: int = 42, n_val: int = 800):
    """The seeded validation split carved from train: ``(val ids, train
    ids)``, the video ids in first-seen order shuffled by Python's
    ``random`` under ``seed``."""
    ids = []
    seen = set()
    with open(txt_path) as f:
        for line in f:
            if "##" in line:
                vid = line.split("##")[0].split(" ")[0]
                if vid not in seen:
                    seen.add(vid)
                    ids.append(vid)
    random.seed(seed)
    random.shuffle(ids)
    return set(ids[:n_val]), set(ids[n_val:])


def convert_tacos(
    jsonl_path: str, relative_time: bool = False, save_float: bool = False
) -> list[dict]:
    out = []
    with open(jsonl_path) as f:
        for line in f:
            if not line.strip():
                continue
            qa = json.loads(line)
            duration = round(qa["duration"], 2)
            if len(qa["relevant_windows"]) != 1:
                raise ValueError(f"TACoS qid {qa['qid']}: {len(qa['relevant_windows'])} "
                                 "windows, expected 1")
            start, end = qa["relevant_windows"][0]
            window, _ = _encode_window(start, end, qa["duration"], relative_time, save_float)
            out.append(
                {
                    "vid": qa["vid"],
                    "qid": "TACoS_" + str(qa["qid"]),
                    "query": qa["query"],
                    "duration": duration,
                    "relevant_windows": [window],
                }
            )
    return out


def convert_activitynet(
    json_path: str, relative_time: bool = False, save_float: bool = False
) -> list[dict]:
    with open(json_path) as f:
        data = json.load(f)
    out = []
    for video_id, sample in data.items():
        duration = sample["duration"]
        for j, (start, end) in enumerate(sample["timestamps"]):
            window, _ = _encode_window(start, end, duration, relative_time, save_float)
            out.append(
                {
                    "vid": video_id,
                    "qid": f"ActivityNet_{video_id}_{j}",
                    "query": sample["sentences"][j],
                    "duration": duration,
                    "relevant_windows": [window],
                }
            )
    return out


# Prompt templates for TAL class queries (the notebook's cell 32).
TAL_TEMPLATES_VIDEO = [
    f"a {kind} of {who}{{}}."
    for kind in ("video", "example", "demonstration")
    for who in ("", "a person ", "a person using ", "a person doing ", "a person during ",
                "a person performing ", "a person practicing ")
]


def convert_activitynet_tal(
    json_path: str, relative_time: bool = False, save_float: bool = False
):
    """ActivityNet-TAL: one record per video with ``[start, end, label]``
    triples; returns (train, val, test, classes), the classes in order of
    first appearance."""
    with open(json_path) as f:
        data = json.load(f)
    if "database" in data:
        data = data["database"]

    splits = {"training": [], "validation": [], "testing": []}
    classes: list[str] = []
    for video_id, sample in data.items():
        vid = "v_" + video_id
        duration = sample["duration"]
        windows = []
        for ann in sample.get("annotations", []):
            start, end = ann["segment"]
            label = ann["label"]
            if label not in classes:
                classes.append(label)
            window, _ = _encode_window(start, end, duration, relative_time, save_float)
            windows.append(window + [label])
        record = {
            "vid": vid,
            "qid": f"ActivityNet_{vid}_0",
            "query": "",
            "duration": duration,
            "relevant_windows": windows,
        }
        splits.setdefault(sample.get("subset", "testing"), []).append(record)
    return splits["training"], splits["validation"], splits["testing"], classes


def transcode_folder(input_dir: str, output_dir: str, size: int) -> int:
    """Every ``.avi``/``.mp4``/``.mkv``/``.mov`` of ``input_dir`` (sorted by
    name) → ``output_dir/<stem>.mp4`` at ``size`` x ``size``; returns the
    count."""
    from mraudio_tpu_torch.data import native_bindings as nb

    lib = nb.load()
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(input_dir)):
        if not name.lower().endswith((".avi", ".mp4", ".mkv", ".mov")):
            continue
        dst = os.path.join(output_dir, os.path.splitext(name)[0] + ".mp4")
        nb.transcode(lib, os.path.join(input_dir, name), dst, size, size)
        count += 1
    return count


def _window_flags(p) -> None:
    p.add_argument("--relative-time", action="store_true")
    p.add_argument("--save-float", action="store_true")


def main(argv=None):
    parser = argparse.ArgumentParser(description="annotation preparation")
    sub = parser.add_subparsers(dest="dataset", required=True)

    ch = sub.add_parser("charades_sta")
    ch.add_argument("--train-txt", required=True)
    ch.add_argument("--test-txt", required=True)
    ch.add_argument("--train-csv", required=True)
    ch.add_argument("--test-csv", required=True)
    ch.add_argument("--output-dir", required=True)
    ch.add_argument("--val-split", action="store_true",
                    help="carve the seeded 800-video val split from train")
    _window_flags(ch)

    for name in ("tacos", "activitynet"):
        p = sub.add_parser(name)
        p.add_argument("--input", required=True)
        p.add_argument("--output", required=True)
        _window_flags(p)

    tr = sub.add_parser("transcode", help="AVI→MP4 + downscale (TACoS prep)")
    tr.add_argument("--input-dir", required=True)
    tr.add_argument("--output-dir", required=True)
    tr.add_argument("--size", type=int, default=224)

    tal = sub.add_parser("activitynet_tal")
    tal.add_argument("--input", required=True)
    tal.add_argument("--output-dir", required=True)
    _window_flags(tal)

    args = parser.parse_args(argv)

    if args.dataset == "charades_sta":
        os.makedirs(args.output_dir, exist_ok=True)
        if args.val_split:
            val_ids, train_ids = charades_val_split(args.train_txt)
        else:
            val_ids, train_ids = None, None
        train = convert_charades_sta(
            args.train_txt, args.train_csv, train_ids,
            args.relative_time, args.save_float,
        )
        save_jsonl(train, os.path.join(args.output_dir, "charades_sta_train.jsonl"))
        if args.val_split:
            val = convert_charades_sta(
                args.train_txt, args.train_csv, val_ids,
                args.relative_time, args.save_float,
            )
            save_jsonl(val, os.path.join(args.output_dir, "charades_sta_val.jsonl"))
        test = convert_charades_sta(
            args.test_txt, args.test_csv, None, args.relative_time, args.save_float
        )
        save_jsonl(test, os.path.join(args.output_dir, "charades_sta_test.jsonl"))
        print(f"wrote {len(train)} train / {len(test)} test records")
    elif args.dataset in ("tacos", "activitynet"):
        convert = convert_tacos if args.dataset == "tacos" else convert_activitynet
        records = convert(args.input, args.relative_time, args.save_float)
        save_jsonl(records, args.output)
        print(f"wrote {len(records)} records")
    elif args.dataset == "transcode":
        count = transcode_folder(args.input_dir, args.output_dir, args.size)
        print(f"transcoded {count} videos to {args.output_dir}")
    elif args.dataset == "activitynet_tal":
        os.makedirs(args.output_dir, exist_ok=True)
        train, val, test, classes = convert_activitynet_tal(
            args.input, args.relative_time, args.save_float
        )
        save_jsonl(train, os.path.join(args.output_dir, "anet_tal_train.jsonl"))
        save_jsonl(val, os.path.join(args.output_dir, "anet_tal_val.jsonl"))
        save_jsonl(test, os.path.join(args.output_dir, "anet_tal_test.jsonl"))
        with open(os.path.join(args.output_dir, "classes.txt"), "w") as f:
            for c in classes:
                f.write(c + "\n")
        print(f"wrote {len(train)}/{len(val)}/{len(test)} records, {len(classes)} classes")


if __name__ == "__main__":
    main()
