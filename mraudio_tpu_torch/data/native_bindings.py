"""ctypes bindings for the native libav decode library.

The port builds its own copy of the shared library from the C++ source
``native/mraudio_native.cc`` into ``build/native/`` on first use, with
the flags and libraries of ``native/Makefile``, and never writes into
``native/``.  Exposes probe / frame-gather / audio-decode, the
transcoder of ``cli/prepare_data.py`` and the media writers.  Where
libav is missing the build fails and :class:`NativeUnavailable` is
raised.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "mraudio_native.cc")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmraudio_native.so")
# native/Makefile's CXXFLAGS and LDLIBS
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
_LDLIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample"]
_LOCK = threading.Lock()
_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def build() -> str:
    """Compile the library into ``build/native/`` (a temporary file
    renamed into place, so concurrent builders never load a partial
    file); returns its path."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ([os.environ.get("CXX", "g++")] + _CXXFLAGS
           + ["-shared", "-o", tmp, _SOURCE] + _LDLIBS)
    try:
        result = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed: {exc}") from exc
    if result.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(
            f"native build failed:\n{result.stdout}\n{result.stderr}"
        )
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SOURCE)):
            build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mr_last_error.restype = ctypes.c_char_p
        lib.mr_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.mr_decode_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.mr_decode_frames_i420.argtypes = lib.mr_decode_frames.argtypes
        lib.mr_decode_audio.restype = ctypes.c_longlong
        lib.mr_decode_audio.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ]
        lib.mr_transcode.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.mr_write_test_video.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ]
        lib.mr_write_test_video_vfr.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.mr_write_test_audio.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_int,
        ]
        lib.mr_write_media.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
        return lib


def _err(lib) -> str:
    return lib.mr_last_error().decode(errors="replace")


def probe(lib, path: str) -> tuple[int, float]:
    n = ctypes.c_longlong()
    fps = ctypes.c_double()
    if lib.mr_probe(path.encode(), ctypes.byref(n), ctypes.byref(fps)) != 0:
        raise IOError(f"probe failed for {path}: {_err(lib)}")
    return int(n.value), float(fps.value)


def decode_frames(
    lib, path: str, indices: np.ndarray, height: int, width: int,
    start: float = -1.0, end: float = -1.0,
) -> np.ndarray:
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(indices), height, width, 3), dtype=np.uint8)
    rc = lib.mr_decode_frames(
        path.encode(),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(indices), height, width, start, end,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        raise IOError(f"decode failed for {path}: {_err(lib)}")
    return out


def decode_frames_i420(
    lib, path: str, indices: np.ndarray, height: int, width: int,
    start: float = -1.0, end: float = -1.0,
) -> np.ndarray:
    """Like :func:`decode_frames` but the codec's I420 planes packed as
    (T, H*3//2, W) uint8, with no RGB conversion (``ops/image.py``
    rebuilds RGB on the device)."""
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    out = np.empty((len(indices), height * 3 // 2, width), dtype=np.uint8)
    rc = lib.mr_decode_frames_i420(
        path.encode(),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(indices), height, width, start, end,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        raise IOError(f"decode failed for {path}: {_err(lib)}")
    return out


def decode_audio(lib, path: str, sample_rate: int, max_seconds: float = 600.0) -> np.ndarray:
    max_samples = int(sample_rate * max_seconds)
    out = np.zeros(max_samples, dtype=np.float32)
    n = lib.mr_decode_audio(
        path.encode(), sample_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
    )
    if n < 0:
        raise IOError(f"audio decode failed for {path}: {_err(lib)}")
    return out[: int(n)]


def transcode(lib, src: str, dst: str, width: int, height: int) -> None:
    """Any video → a video-only H.264 mp4 downscaled to ``width`` x
    ``height`` (the reference notebook's ffmpeg step)."""
    if lib.mr_transcode(src.encode(), dst.encode(), width, height) != 0:
        raise IOError(f"transcode failed for {src}: {_err(lib)}")


def write_test_video(lib, path: str, frames: np.ndarray, fps: float) -> None:
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, _ = frames.shape
    rc = lib.mr_write_test_video(
        path.encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n, h, w, fps,
    )
    if rc != 0:
        raise IOError(f"write_test_video failed: {_err(lib)}")


def write_test_video_vfr(lib, path: str, frames: np.ndarray, fps: float,
                         pts: np.ndarray) -> None:
    """Variable-frame-rate test media: frame ``i`` presented at ``pts[i]``
    ticks of 1/``fps``, so the container's average and nominal rates
    disagree, as in consumer VBR encodes."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    pts = np.ascontiguousarray(pts, dtype=np.int64)
    n, h, w, _ = frames.shape
    if pts.shape != (n,):
        raise ValueError(f"pts {pts.shape} for {n} frames")
    rc = lib.mr_write_test_video_vfr(
        path.encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n, h, w, fps,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if rc != 0:
        raise IOError(f"write_test_video_vfr failed: {_err(lib)}")


def write_media(
    lib, path: str, frames: np.ndarray, fps: float,
    samples: np.ndarray, sample_rate: int, gop: int = 60,
) -> None:
    """Write an mp4 with muxed H.264 video + AAC audio."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    n, h, w, _ = frames.shape
    rc = lib.mr_write_media(
        path.encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n, h, w, fps,
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), sample_rate, gop,
    )
    if rc != 0:
        raise IOError(f"write_media failed: {_err(lib)}")


def write_test_audio(lib, path: str, samples: np.ndarray, sample_rate: int) -> None:
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    rc = lib.mr_write_test_audio(
        path.encode(),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), sample_rate,
    )
    if rc != 0:
        raise IOError(f"write_test_audio failed: {_err(lib)}")
