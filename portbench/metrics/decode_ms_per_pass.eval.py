"""Wall milliseconds of the ``decode`` span per decode pass, over the
untraced window (the decoders time their span with the device
synchronised at both ends)."""


def read(record):
    stats = record["window"]["batch_stats"]
    passes = sum(b.get("decode_steps", 0) for b in stats)
    if not passes:
        return None
    return sum(b["decode_s"] for b in stats) / passes * 1e3
