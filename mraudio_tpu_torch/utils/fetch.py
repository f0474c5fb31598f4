"""Checkpoint fetch-and-cache (the JAX package's ``utils/fetch.py``).

Resolves a URL-or-path to a local file, downloading a URL into a cache
directory once (``MRAUDIO_CACHE``, default ``~/.cache/mraudio_tpu_torch``):
the capability LAVIS ``download_cached_file``/``is_url`` give the
reference's resume.  Every write lands under a temporary name and is
renamed into place, so processes of one host that resolve the same URL
together (the ranks of a mesh) never read a partial file.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import tarfile
import tempfile
import urllib.request
import zipfile

_URL_RE = re.compile(r"^https?://", re.IGNORECASE)
META_SUFFIX = ".meta.json"       # train/checkpoint.py's step-position sidecar


def is_url(url_or_path: str) -> bool:
    return bool(_URL_RE.match(url_or_path))


def cache_dir() -> str:
    root = os.environ.get(
        "MRAUDIO_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "mraudio_tpu_torch"))
    os.makedirs(root, exist_ok=True)
    return root


def cached_path(url_or_path: str) -> str:
    """A local path for ``url_or_path``: a path must exist; a URL is
    downloaded into the cache once, under a name derived from the URL."""
    if not is_url(url_or_path):
        if not os.path.exists(url_or_path):
            raise FileNotFoundError(url_or_path)
        return url_or_path
    name = hashlib.sha1(url_or_path.encode()).hexdigest()[:16]
    base = os.path.basename(url_or_path.split("?")[0]) or "checkpoint"
    target = os.path.join(cache_dir(), f"{name}-{base}")
    if os.path.exists(target):
        return target
    fd, tmp = tempfile.mkstemp(dir=cache_dir(), suffix=".tmp")
    os.close(fd)
    try:
        urllib.request.urlretrieve(url_or_path, tmp)  # noqa: S310
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _is_torch_save(path: str) -> bool:
    """``torch.save`` writes a zip whose entries all sit under one
    directory holding ``data.pkl`` (a tar holding such a file also reads
    as that zip, so a tar is ruled out first)."""
    if tarfile.is_tarfile(path) or not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
    return any(n.endswith("/data.pkl") for n in names) and all("/" in n for n in names)


def _extract(archive: str, source: str) -> str:
    """Unpack ``archive`` once beside itself; returns the directory."""
    dest = archive + ".extracted"
    if os.path.isdir(dest):
        return dest
    tmp = tempfile.mkdtemp(dir=os.path.dirname(archive), suffix=".tmp")
    try:
        if tarfile.is_tarfile(archive):
            with tarfile.open(archive) as tf:
                tf.extractall(tmp, filter="data")
        elif zipfile.is_zipfile(archive):
            with zipfile.ZipFile(archive) as zf:
                zf.extractall(tmp)
        else:
            raise ValueError(f"{source}: neither a checkpoint nor a tar/zip archive of one")
        try:
            os.rename(tmp, dest)
        except OSError:
            if not os.path.isdir(dest):     # not another process's finished copy
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def cached_checkpoint(url_or_path: str) -> str:
    """Resolve a URL-or-path to a LOCAL checkpoint file of the port
    (``train/checkpoint.py``: one ``torch.save`` file with its
    ``.meta.json`` sidecar beside it), the resume-from-URL capability of
    the reference's ``_load_checkpoint``.

    A path passes straight through.  A URL names either the checkpoint
    file itself or a tar/zip archive holding it (and, for a resume inside
    its epoch, its sidecar); an archive is downloaded and extracted once,
    and the one checkpoint file inside is returned, its sidecar beside it.
    An archive without exactly one checkpoint file raises ``ValueError``.
    """
    if not is_url(url_or_path):
        return url_or_path
    local = cached_path(url_or_path)
    if _is_torch_save(local):
        return local
    root = _extract(local, url_or_path)
    found = [os.path.join(d, f) for d, _, files in os.walk(root) for f in files
             if not f.endswith(META_SUFFIX)]
    checkpoints = [p for p in found if _is_torch_save(p)]
    if len(checkpoints) != 1 or len(found) != 1:
        raise ValueError(f"{url_or_path}: expected one checkpoint file (and its {META_SUFFIX} "
                         f"sidecar) in the archive, found {sorted(found)}")
    return checkpoints[0]
