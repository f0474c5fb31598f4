"""The port's ``cli/prepare_data.py`` against the JAX package's on the
same small input files (``tests/test_misc_utils.py``'s cases, widened):
every subcommand's output files byte for byte, under the four window
encodings (absolute or relative times, integers or floats); the seeded
Charades validation split; the transcoder's mp4s decoding to the JAX
CLI's frames bit for bit."""

import json

import numpy as np
import pytest

from mraudio_tpu.cli import prepare_data as j_prep
from mraudio_tpu_torch.cli import prepare_data as prep
from mraudio_tpu_torch.data import native_bindings as nb

ENCODINGS = [[], ["--relative-time"], ["--save-float"], ["--relative-time", "--save-float"]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep_inputs")
    vids = [f"VID{i:03d}" for i in range(1000)]
    lengths = {v: 20.0 + (i * 7.31) % 90 for i, v in enumerate(vids)}
    train = [f"{v} {i % 9 * 1.7:.1f} {i % 9 * 1.7 + 4.2 + i % 5:.1f}##does thing {i}"
             for i, v in enumerate(vids) for _ in range(1 + i % 2)]
    (root / "train.txt").write_text("\n".join(train) + "\n\n")
    # an end past the duration: clamped
    (root / "test.txt").write_text("".join(f"{v} 1.0 {lengths[v] + 3:.1f}##holds a cup\n"
                                           for v in vids[:20]))
    for name in ("train.csv", "test.csv"):
        (root / name).write_text("id,length,objects\n" + "".join(
            f"{v},{lengths[v]},{'cup;table' if i % 3 else ''}\n" for i, v in enumerate(vids)))
    (root / "tacos.jsonl").write_text("".join(json.dumps({
        "vid": f"s13-d{i}", "qid": i, "query": f"cuts a cucumber {i}",
        "duration": 123.456 + i, "relevant_windows": [[10.4 + i, 50.6 + 2 * i]]}) + "\n"
        for i in range(6)))
    (root / "anet.json").write_text(json.dumps({
        "v_abc": {"duration": 100.0, "timestamps": [[0, 30], [40, 90.7]],
                  "sentences": ["first thing", "second thing"]},
        "v_def": {"duration": 55.5, "timestamps": [[3.3, 54.9]], "sentences": ["only"]}}))
    (root / "tal.json").write_text(json.dumps({"database": {
        "abc123": {"duration": 120.0, "subset": "training", "annotations": [
            {"segment": [5.2, 30.9], "label": "Archery"},
            {"segment": [60.0, 90.5], "label": "Archery"}]},
        "def456": {"duration": 60.0, "subset": "validation", "annotations": [
            {"segment": [0.0, 10.0], "label": "Drinking coffee"}]},
        "ghi789": {"duration": 30.0, "annotations": [
            {"segment": [1.0, 2.0], "label": "Surfing"}]}}}))
    return root


def _args(dataset, inputs, out, encoding):
    if dataset == "charades_sta":
        return ["charades_sta", "--train-txt", str(inputs / "train.txt"), "--test-txt",
                str(inputs / "test.txt"), "--train-csv", str(inputs / "train.csv"),
                "--test-csv", str(inputs / "test.csv"), "--output-dir", str(out),
                "--val-split", *encoding]
    if dataset == "activitynet_tal":
        return [dataset, "--input", str(inputs / "tal.json"), "--output-dir", str(out),
                *encoding]
    src = {"tacos": "tacos.jsonl", "activitynet": "anet.json"}[dataset]
    out.mkdir()
    return [dataset, "--input", str(inputs / src), "--output", str(out / "out.jsonl"), *encoding]


@pytest.mark.parametrize("encoding", ENCODINGS, ids=lambda e: "-".join(e) or "absolute")
@pytest.mark.parametrize("dataset", ["charades_sta", "tacos", "activitynet", "activitynet_tal"])
def test_cli_output_matches_jax_byte_for_byte(inputs, tmp_path, dataset, encoding):
    prep.main(_args(dataset, inputs, tmp_path / "port", encoding))
    j_prep.main(_args(dataset, inputs, tmp_path / "jax", encoding))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names and sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    if dataset == "charades_sta":
        val = (tmp_path / "port" / "charades_sta_val.jsonl").read_text().splitlines()
        assert len({json.loads(line)["vid"] for line in val}) == 800


def test_converters_and_split_match_jax(inputs):
    got = prep.charades_val_split(str(inputs / "train.txt"), n_val=100)
    assert got == j_prep.charades_val_split(str(inputs / "train.txt"), n_val=100)
    assert len(got[0]) == 100 and not (got[0] & got[1])
    assert prep.TAL_TEMPLATES_VIDEO == j_prep.TAL_TEMPLATES_VIDEO
    assert (prep.convert_tacos(str(inputs / "tacos.jsonl"))
            == j_prep.convert_tacos(str(inputs / "tacos.jsonl")))
    assert (prep.convert_activitynet_tal(str(inputs / "tal.json"), relative_time=True)
            == j_prep.convert_activitynet_tal(str(inputs / "tal.json"), relative_time=True))


def test_window_outside_the_duration_raises(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps({"vid": "a", "qid": 1, "query": "q", "duration": 10.0,
                                "relevant_windows": [[2.0, 14.0]]}) + "\n")
    with pytest.raises(ValueError, match="outside"):
        prep.convert_tacos(str(path), relative_time=True)


def test_transcode_subcommand_matches_jax(tmp_path):
    lib = nb.load()
    src = tmp_path / "in"
    src.mkdir()
    frames = np.zeros((24, 96, 128, 3), np.uint8)
    for i in range(24):
        frames[i] = 10 * i
    nb.write_test_video(lib, str(src / "clip.avi"), frames, fps=12.0)
    nb.write_test_video(lib, str(src / "b.mov"), frames[:12], fps=12.0)
    (src / "notes.txt").write_text("not a video")
    prep.main(["transcode", "--input-dir", str(src), "--output-dir", str(tmp_path / "port"),
               "--size", "64"])
    j_prep.main(["transcode", "--input-dir", str(src), "--output-dir", str(tmp_path / "jax"),
                 "--size", "64"])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["b.mp4", "clip.mp4"]
    for name, n in (("clip.mp4", 24), ("b.mp4", 12)):
        got, want = (str(tmp_path / side / name) for side in ("port", "jax"))
        assert nb.probe(lib, got)[0] == n
        idx = np.arange(n, dtype=np.int64)
        assert np.array_equal(nb.decode_frames(lib, got, idx, 64, 64),
                              nb.decode_frames(lib, want, idx, 64, 64))
