"""The port's media fabricator (``data/media.py``) and its two native
writers (``data/native_bindings.py::{transcode,write_test_video_vfr}``).

* ``fabricate_frames`` and ``fabricate_audio`` give the JAX package's
  arrays bit for bit from the same generator stream, and
  ``fabricate_media_set`` writes the JAX package's manifest and
  annotation JSONL byte for byte;
* its mp4s pass ``tests/test_media_bench.py``'s checks through the port's
  bindings, at that file's sizes: probe and audio, the manifest cache,
  gap-seek gathers bit-identical to a sequential decode in RGB and I420,
  and the port's dataset over the native source;
* the writers pass ``tests/test_native_decode.py``'s checks of the
  transcoder and of variable-frame-rate files.

The library is built from ``native/mraudio_native.cc`` with libav, which
this host has; without it the build raises ``NativeUnavailable``.
"""

import json
import os

import numpy as np
import pytest

from mraudio_tpu.data import media as j_media
from mraudio_tpu_torch.config import DataConfig
from mraudio_tpu_torch.data import media
from mraudio_tpu_torch.data import native_bindings as nb
from mraudio_tpu_torch.data.dataset import BatchLoader, MRDataset

SET = dict(n_videos=2, duration=4.0, fps=8.0, height=96, width=128, queries_per_video=2,
           gop=8, seed=7)


@pytest.fixture(scope="module")
def lib():
    return nb.load()


@pytest.fixture(scope="module")
def media_root(tmp_path_factory, lib):
    root = str(tmp_path_factory.mktemp("torch_media"))
    return root, media.fabricate_media_set(root, **SET)


def test_fabricated_arrays_match_jax():
    for seed in (0, 11):
        rng, j_rng = np.random.default_rng((seed, 1)), np.random.default_rng((seed, 1))
        frames = media.fabricate_frames(rng, 12, 48, 64)
        want = j_media.fabricate_frames(j_rng, 12, 48, 64)
        assert frames.dtype == want.dtype == np.uint8 and np.array_equal(frames, want)
        audio = media.fabricate_audio(rng, 1.5, 16000)
        want = j_media.fabricate_audio(j_rng, 1.5, 16000)
        assert audio.dtype == want.dtype == np.float32 and np.array_equal(audio, want)


def test_media_set_writes_jax_manifest_and_annotations(media_root, tmp_path):
    root, ann = media_root
    j_ann = j_media.fabricate_media_set(str(tmp_path), **SET)
    assert open(ann, "rb").read() == open(j_ann, "rb").read()
    for name in (media.MANIFEST, "annotations.jsonl"):
        assert (open(os.path.join(root, name), "rb").read()
                == (tmp_path / name).read_bytes()), name
    assert json.load(open(os.path.join(root, media.MANIFEST)))["version"] == 3
    assert sorted(p for p in os.listdir(root) if p.endswith(".mp4")) == [
        "media000.mp4", "media001.mp4"]


def test_write_media_probe_and_audio(media_root, lib):
    root, _ = media_root
    path = os.path.join(root, "media000.mp4")
    n, fps = nb.probe(lib, path)
    assert n == 32
    assert abs(fps - 8.0) < 0.35
    wave = nb.decode_audio(lib, path, 16000, max_seconds=5.0)
    assert len(wave) > 16000 * 3.5
    assert float(np.sqrt((wave ** 2).mean())) > 0.05


def test_manifest_caches(media_root):
    root, ann = media_root
    mtime = os.path.getmtime(os.path.join(root, "media000.mp4"))
    assert media.fabricate_media_set(root, **SET) == ann
    assert os.path.getmtime(os.path.join(root, "media000.mp4")) == mtime


@pytest.mark.parametrize("i420", [False, True])
def test_gap_seek_matches_sequential(media_root, lib, i420):
    """Sparse gathers (which seek inside the file) return the frames of a
    dense sequential decode, bit for bit, in RGB and in I420."""
    root, _ = media_root
    path = os.path.join(root, "media001.mp4")
    n, _ = nb.probe(lib, path)
    decode = nb.decode_frames_i420 if i420 else nb.decode_frames
    dense = np.arange(n, dtype=np.int64)
    all_frames = decode(lib, path, dense, 64, 64)
    for stride in (5, 9, 15):
        assert np.array_equal(decode(lib, path, dense[::stride], 64, 64),
                              all_frames[::stride]), stride


def test_dataset_native_path_on_fabricated_media(media_root):
    root, ann = media_root
    cfg = DataConfig(video_folder=root, annotation_file=ann, n_frms=6, image_size=64,
                     video_source="native")
    ds = MRDataset(cfg, annotation_path=ann)
    assert len(ds) == 4
    s = ds.get(0, strict=True)
    assert s.video.shape == (6, 64, 64, 3)
    assert s.video.std() > 5.0
    assert s.audio.dtype == np.int16
    assert np.abs(s.audio.astype(np.int32)).mean() > 100
    assert s.timestamps.shape == (6,)
    assert s.timestamps[-1] <= 4
    batches = list(BatchLoader(ds, batch_size=3, num_threads=2))
    assert len(batches) == 2
    assert batches[0].video.shape == (3, 6, 64, 64, 3)
    assert batches[1].valid.tolist() == [True, False, False]
    rows = [json.loads(line) for line in open(ann)]
    for r in rows:
        assert set(r) == {"vid", "qid", "query", "duration", "relevant_windows"}
        (w,) = r["relevant_windows"]
        assert 0 <= w[0] < w[1] <= r["duration"]


def _ramp(n=48, h=64, w=64):
    """Frames whose brightness ramps with the index, so a decoded frame
    can be matched back to it through the lossy codec."""
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i] = int(255 * i / (n - 1))
    return frames


def test_transcode_avi_to_mp4(lib, tmp_path):
    src = str(tmp_path / "clip.avi")
    nb.write_test_video(lib, src, _ramp(n=24, h=96, w=128), fps=12.0)
    dst = str(tmp_path / "clip.mp4")
    nb.transcode(lib, src, dst, 64, 64)
    vlen, _ = nb.probe(lib, dst)
    assert vlen == 24
    frames = nb.decode_frames(lib, dst, np.array([0, 23]), 64, 64)
    assert frames.shape == (2, 64, 64, 3)
    assert frames[1].mean() > frames[0].mean() + 100
    with pytest.raises(IOError, match="transcode failed"):
        nb.transcode(lib, str(tmp_path / "missing.avi"), dst, 64, 64)


def _vfr(lib, path, n):
    """A file whose pts skip every 8th tick (drifting 12.5% late)."""
    frames = _ramp(n=n)
    nb.write_test_video_vfr(lib, path, frames, fps=12.0,
                            pts=np.array([i + i // 8 for i in range(n)], np.int64))
    return frames


def test_vfr_probe_and_sequential_gather(lib, tmp_path):
    path = str(tmp_path / "vfr.mp4")
    frames = _vfr(lib, path, 96)
    vlen, fps = nb.probe(lib, path)
    assert vlen == 96
    assert 9.0 < fps < 12.5
    idx = np.array([0, 3, 7, 11])
    out = nb.decode_frames(lib, path, idx, 32, 32)
    np.testing.assert_allclose(out.reshape(len(idx), -1).mean(axis=1),
                               frames[idx].reshape(len(idx), -1).mean(axis=1), atol=12)
    with pytest.raises(ValueError, match="pts"):
        nb.write_test_video_vfr(lib, path, frames, 12.0, np.arange(3, dtype=np.int64))


def test_vfr_sparse_gather_after_seeks(lib, tmp_path):
    path = str(tmp_path / "vfr_long.mp4")
    n = 240
    _vfr(lib, path, n)
    idx = np.array([5, 80, 160, 230])
    out = nb.decode_frames(lib, path, idx, 32, 32)
    got_idx = out.reshape(len(idx), -1).mean(axis=1) / (255.0 / (n - 1))
    assert np.all(np.abs(got_idx - idx) <= idx // 8 + 3), (got_idx.tolist(), idx.tolist())
    assert np.all(np.diff(got_idx) > 0)


def test_vfr_subclip_window(lib, tmp_path):
    path = str(tmp_path / "vfr_clip.mp4")
    n = 120
    _vfr(lib, path, n)
    out = nb.decode_frames(lib, path, np.array([0, 10, 20]), 32, 32, start=4.0, end=8.0)
    got_idx = out.reshape(3, -1).mean(axis=1) / (255.0 / (n - 1))
    assert np.all(got_idx >= 35) and np.all(got_idx <= 105)
    assert np.all(np.diff(got_idx) > 0)
