"""Frame-index sampling: uniform for eval, one random index per equal
interval for train.  Padding to the static ``n_frms`` happens at the
index level (repeat the last index), so the decoder fetches exactly the
frames the model will see."""

from __future__ import annotations

import numpy as np


def sample_frame_indices(
    vlen: int,
    n_frms: int,
    sampling: str = "uniform",
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Select ``min(n_frms, vlen)`` frame indices in ``[0, vlen)`` then
    repeat the last index up to ``n_frms`` (static output shape).

    ``uniform``: ``linspace(0, vlen, num, endpoint=False)`` truncated to
    int.  ``random``: interval edges from an inclusive linspace; one
    uniform choice inside each interval.
    """
    if vlen <= 0:
        raise ValueError(f"vlen must be positive, got {vlen}")
    num = min(n_frms, vlen)

    if sampling == "uniform":
        indices = np.linspace(0, vlen, num=num, endpoint=False).astype(int)
    elif sampling == "random":
        if rng is None:
            rng = np.random.default_rng()
        edges = np.linspace(0, vlen, num=num + 1).astype(int)
        indices = np.array(
            [
                low if low == high else rng.integers(low, high)
                for low, high in zip(edges[:-1], edges[1:])
            ]
        )
    else:
        raise NotImplementedError(f"Sampling strategy '{sampling}' is not implemented.")

    if num < n_frms:
        indices = np.concatenate([indices, np.full(n_frms - num, indices[-1])])
    return indices


def frame_timestamps(indices: np.ndarray, fps: float) -> list[int]:
    """Per-frame integer timestamps in seconds."""
    return [round(float(idx) / fps) for idx in indices]
