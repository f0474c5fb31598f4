"""The port's data pipeline against the JAX package's on the same inputs:
annotations, frame sampling, the synthetic and native media sources,
``MRDataset``/``collate`` and the ``BatchLoader``'s order and padding.
Everything here is exact: arrays and records must be equal."""

import dataclasses
import json

import numpy as np
import pytest

from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.data import annotations as j_ann
from mraudio_tpu.data import native_bindings as j_nb
from mraudio_tpu.data import sampling as j_sampling
from mraudio_tpu.data.audio import NativeAudioSource as JNativeAudio
from mraudio_tpu.data.audio import SyntheticAudioSource as JSyntheticAudio
from mraudio_tpu.data.dataset import BatchLoader as JBatchLoader
from mraudio_tpu.data.dataset import MRDataset as JDataset
from mraudio_tpu.data.video import NativeVideoSource as JNativeVideo
from mraudio_tpu.data.video import SyntheticVideoSource as JSyntheticVideo
from mraudio_tpu_torch.config import DataConfig, tiny_data_config
from mraudio_tpu_torch.data import annotations, native_bindings, sampling
from mraudio_tpu_torch.data.audio import NativeAudioSource, SyntheticAudioSource
from mraudio_tpu_torch.data.dataset import BatchLoader, MRDataset
from mraudio_tpu_torch.data.video import NativeVideoSource, SyntheticVideoSource


def _anns(n):
    return [{"vid": f"clip{i}", "qid": 100 + i, "query": f"someone does thing {i}",
             "duration": 150 - 11 * i, "relevant_windows": [[2 * i, 2 * i + 20]]}
            for i in range(n)]


def _assert_batches_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_annotations_load_and_chunk(tmp_path):
    path = tmp_path / "a.jsonl"
    path.write_text("".join(json.dumps(a) + "\n\n" for a in _anns(7)))
    assert annotations.load_annotations(str(path)) == j_ann.load_annotations(str(path))
    for n in (0, 1, 5, 7, 10):
        for k in (1, 2, 3, 4):
            for i in range(k):
                assert (annotations.chunk_annotations(list(range(n)), k, i)
                        == j_ann.chunk_annotations(list(range(n)), k, i))
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"vid": "x"}) + "\n")
    with pytest.raises(ValueError, match="missing keys"):
        annotations.load_annotations(str(bad))


def test_sampling_uniform_random_and_timestamps():
    for vlen in (1, 3, 59, 60, 61, 4500):
        for n in (4, 60):
            np.testing.assert_array_equal(sampling.sample_frame_indices(vlen, n),
                                          j_sampling.sample_frame_indices(vlen, n))
            ours = sampling.sample_frame_indices(vlen, n, "random", np.random.default_rng(vlen))
            theirs = j_sampling.sample_frame_indices(vlen, n, "random",
                                                     np.random.default_rng(vlen))
            np.testing.assert_array_equal(ours, theirs)
            assert sampling.frame_timestamps(ours, 29.97) == \
                j_sampling.frame_timestamps(theirs, 29.97)


def test_synthetic_sources_identical():
    idx = sampling.sample_frame_indices(300, 8)
    for path in ("a/clip0.mp4", "b/other.mp4"):
        assert SyntheticVideoSource().probe(path) == JSyntheticVideo().probe(path)
        np.testing.assert_array_equal(SyntheticVideoSource().get_batch(path, idx, 28, 28),
                                      JSyntheticVideo().get_batch(path, idx, 28, 28))
        np.testing.assert_array_equal(SyntheticAudioSource().load(path, 12345, 16000),
                                      JSyntheticAudio().load(path, 12345, 16000))


@pytest.mark.parametrize("dataset", ["tiny", "QVH"])
def test_dataset_get_and_collate(dataset):
    if dataset == "tiny":
        cfg, jcfg = tiny_data_config(n_frms=4), j_tiny_data(n_frms=4)
    else:   # full QVH shapes: 60 frames, 152 s of audio (image size cut to keep it quick)
        cfg = DataConfig.for_dataset("QVH", video_source="synthetic", image_size=56)
        from mraudio_tpu.config import DataConfig as JDataConfig
        jcfg = JDataConfig.for_dataset("QVH", video_source="synthetic", image_size=56)
    anns = _anns(3)
    ds, jds = MRDataset(cfg, annotations=anns), JDataset(jcfg, annotations=anns)
    assert ds.audio_num_samples == jds.audio_num_samples
    from mraudio_tpu.data.dataset import collate as j_collate
    from mraudio_tpu_torch.data.dataset import collate

    batch = collate([ds.get(i) for i in range(3)], 4)
    _assert_batches_equal(batch, j_collate([jds.get(i) for i in range(3)], 4))
    assert batch.valid.tolist() == [True, True, True, False]
    assert batch.qid[3] == batch.qid[2]


def test_blank_sample_fallback(tmp_path):
    cfg = tiny_data_config().replace(video_source="npy", video_folder=str(tmp_path))
    sample = MRDataset(cfg, annotations=_anns(1)).get(0)     # no such .npy file
    assert sample.video.shape == (4, 28, 28, 3) and not sample.video.any()
    assert sample.qid == 100
    with pytest.raises(FileNotFoundError):
        MRDataset(cfg, annotations=_anns(1)).get(0, strict=True)


def test_batch_loader_order_and_padding():
    cfg, jcfg = tiny_data_config(n_frms=2), j_tiny_data(n_frms=2)
    anns = _anns(7)
    for kw in (dict(), dict(shuffle=True, seed=3), dict(shard_index=1, shard_count=2)):
        ours = list(BatchLoader(MRDataset(cfg, annotations=anns), 3, num_threads=2, **kw))
        theirs = list(JBatchLoader(JDataset(jcfg, annotations=anns), 3, num_threads=2, **kw))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _assert_batches_equal(a, b)
    plain = list(BatchLoader(MRDataset(cfg, annotations=anns), 3))
    assert [b.qid for b in plain][-1] == [106, 106, 106]
    assert [b.valid.sum() for b in plain] == [3, 3, 1]


@pytest.fixture(scope="module")
def lib():
    try:
        return native_bindings.load()
    except native_bindings.NativeUnavailable as exc:
        pytest.skip(f"native library unavailable: {exc}")


def test_native_clip_decodes_identically(lib, tmp_path):
    """A clip written by the port's writer decodes to the same frames and
    waveform through both packages' native sources."""
    try:
        j_nb.load()
    except j_nb.NativeUnavailable as exc:
        pytest.skip(f"the JAX package's native library is unavailable: {exc}")
    n, h, w, fps, rate = 24, 64, 64, 12.0, 16000
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i] = int(255 * i / (n - 1))
        frames[i, : h // 2, :, 0] = 255 - frames[i, 0, 0, 0]
    t = np.arange(2 * rate) / rate
    path = str(tmp_path / "clip.mp4")
    native_bindings.write_media(lib, path, frames, fps, (0.3 * np.sin(2 * np.pi * 440 * t))
                                .astype(np.float32), rate, gop=6)
    ours, theirs = NativeVideoSource(), JNativeVideo()
    assert ours.probe(path) == theirs.probe(path)
    vlen, _ = ours.probe(path)
    idx = sampling.sample_frame_indices(vlen, 8)
    got = ours.get_batch(path, idx, 32, 48)
    np.testing.assert_array_equal(got, theirs.get_batch(path, idx, 32, 48))
    assert got.shape == (8, 32, 48, 3) and got.std() > 0
    np.testing.assert_array_equal(NativeAudioSource().load(path, 20000, rate),
                                  JNativeAudio().load(path, 20000, rate))
