"""``utils/fetch.py``, resuming the trainer from a URL, and
``Trainer.reload_best_model``, on the tiny run of
``tests/test_torch_trainer.py``.

The download is ``urllib.request.urlretrieve`` monkeypatched to copy a
local file (no network), as ``tests/test_preempt.py`` does for the JAX
package; the cache, the extraction, the sidecar's placement and the
restored state run for real.  The port's checkpoint is one ``torch.save``
file with its ``.meta.json`` sidecar, so a URL names that file or a
tar/zip archive holding it and its sidecar (ROADMAP.md C.3)."""

import json
import os
import shutil
import tarfile
import urllib.request
import zipfile

import pytest

import torch

from mraudio_tpu.utils import fetch as j_fetch
from mraudio_tpu_torch.train import trainer as trainer_mod
from mraudio_tpu_torch.train.checkpoint import load_checkpoint
from mraudio_tpu_torch.utils import fetch
from test_torch_trainer import anns, configs, fresh_model  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.fixture
def downloads(tmp_path, monkeypatch):
    """Route every URL to a local file: ``serve[url] = path``; returns
    (serve, the list of URLs fetched)."""
    serve, fetched = {}, []

    def urlretrieve(url, dst):
        fetched.append(url)
        shutil.copyfile(serve[url], dst)

    monkeypatch.setenv("MRAUDIO_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    return serve, fetched


def test_is_url_cache_dir_and_cached_path(tmp_path, downloads):
    serve, fetched = downloads
    assert fetch.is_url("https://example.invalid/x.pth") and fetch.is_url("HTTP://a/b")
    assert not fetch.is_url("/tmp/x.pth") and not fetch.is_url("file:///x")
    assert fetch.cache_dir() == str(tmp_path / "cache")
    local = tmp_path / "w.pth"
    local.write_bytes(b"abc")
    assert fetch.cached_path(str(local)) == str(local)
    with pytest.raises(FileNotFoundError):
        fetch.cached_path(str(tmp_path / "missing.pth"))
    url = "https://example.invalid/dir/w.pth?token=1"
    serve[url] = local
    got = fetch.cached_path(url)
    assert open(got, "rb").read() == b"abc" and fetched == [url]
    assert fetch.cached_path(url) == got and fetched == [url]      # the cache hit
    # the JAX package's cache name for the same URL
    j_name = os.path.basename(j_fetch.cached_path(url))
    assert os.path.basename(got) == j_name
    assert sorted(os.listdir(tmp_path / "cache")) == [j_name]      # no temporary left


@pytest.fixture
def saved(anns, tmp_path):  # noqa: F811
    """A trainer of the tiny run and its ``checkpoint_0`` at the end of
    epoch 0, with the sidecar."""
    _, cfg = configs(anns, tmp_path / "src")
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    trainer.global_step = trainer.steps_per_epoch
    with torch.no_grad():
        for p in trainer.trainable.values():
            p.add_(0.01)
    return trainer, trainer._save_checkpoint(0, is_best=False)


def _archive(kind, path, dst, extra=()):
    members = [(path, os.path.basename(path)), (path + ".meta.json",
                                                os.path.basename(path) + ".meta.json"),
               *extra]
    if kind == "tar":
        with tarfile.open(dst, "w") as tf:
            for src, arc in members:
                tf.add(src, arcname=arc)
    else:
        with zipfile.ZipFile(dst, "w") as zf:
            for src, arc in members:
                zf.write(src, arc)
    return dst


def _resume(anns, out, url):  # noqa: F811
    _, cfg = configs(anns, out, resume_ckpt_path=url)
    return trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")


@pytest.mark.parametrize("kind", ["tar", "zip"])
def test_url_resume_from_an_archive(anns, saved, tmp_path, downloads, kind):  # noqa: F811
    """A URL naming an archive of the checkpoint and its sidecar resumes
    at the next epoch with the saved step counter, leaves and optimizer
    state; a second resume from the URL downloads nothing."""
    serve, fetched = downloads
    src, path = saved
    url = f"https://example.invalid/ckpt.{kind}"
    serve[url] = _archive(kind, path, tmp_path / f"ckpt.{kind}")
    for i in range(2):
        tr = _resume(anns, tmp_path / f"dst{i}", url)
        assert (tr.start_epoch, tr.global_step) == (1, src.steps_per_epoch)
        for k, p in src.trainable.items():
            assert torch.equal(tr.trainable[k], p), k
        want, got = src.opt.state_dict(), tr.opt.state_dict()
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert fetched == [url]


def test_url_resume_from_the_checkpoint_file(anns, saved, tmp_path, downloads):  # noqa: F811
    """A URL naming the checkpoint file itself: no sidecar comes with it,
    so the resume takes the epoch from the checkpoint (the next one)."""
    serve, _ = downloads
    src, path = saved
    url = "https://example.invalid/checkpoint_0"
    serve[url] = path
    tr = _resume(anns, tmp_path / "dst", url)
    assert (tr.start_epoch, tr.global_step) == (1, tr.steps_per_epoch)
    assert all(torch.equal(tr.trainable[k], p) for k, p in src.trainable.items())


def test_bad_archive_raises(saved, tmp_path, downloads):
    serve, _ = downloads
    _, path = saved
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an archive" * 10)
    two = _archive("tar", path, tmp_path / "two.tar", extra=[(path, "other/checkpoint_1")])
    empty = tmp_path / "empty.tar"
    with tarfile.open(empty, "w") as tf:
        tf.add(path + ".meta.json", arcname="checkpoint_0.meta.json")
    for name, src in (("junk.bin", junk), ("two.tar", two), ("empty.tar", empty)):
        url = f"https://example.invalid/{name}"
        serve[url] = src
        with pytest.raises(ValueError, match="archive"):
            fetch.cached_checkpoint(url)


def test_reload_best_model_restores_leaves_not_optimizer(anns, tmp_path):  # noqa: F811
    """After training, perturbed trainable leaves come back to
    ``checkpoint_best``'s; the optimizer state stays as it was."""
    _, cfg = configs(anns, tmp_path)
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    scores = iter([5.0, 2.0])
    trainer.eval_epoch = lambda: {"brief": {"MR-full-R1-avg": next(scores)}}
    assert trainer.train()["best_epoch"] == 0
    best = load_checkpoint(str(tmp_path / "checkpoint_best"))["model"]
    final = {k: p.detach().clone() for k, p in trainer.trainable.items()}
    assert any(not torch.equal(final[k], best[k]) for k in best)     # epoch 1 moved them
    with torch.no_grad():
        for p in trainer.trainable.values():
            p.add_(1.0)
    opt = {k: v.clone() for k, v in trainer.opt.state_dict().items()}
    trainer.reload_best_model()
    assert sorted(best) == sorted(trainer.trainable)
    for k, p in trainer.trainable.items():
        assert torch.equal(p.detach(), best[k]) and p.requires_grad, k
    after = trainer.opt.state_dict()
    assert sorted(after) == sorted(opt) and all(torch.equal(after[k], opt[k]) for k in opt)
    assert json.load(open(tmp_path / "checkpoint_best.meta.json"))["epoch"] == 0
