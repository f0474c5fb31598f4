"""The window's matmul FLOPs (the clips completed, at the shapes the
program ran: ``portbench/flops.py``) over its wall seconds times the
card's dense bf16 peak."""

from portbench import flops


def read(record):
    w = record["window"]
    if w["seconds"] <= 0 or not w["flops"]:
        return None
    try:
        peak, _ = flops.peaks_for(record["device_name"])
    except KeyError:          # no card with a known peak: nothing to read
        return None
    return w["flops"] / (w["seconds"] * peak) * 100.0
