"""Device milliseconds per clip launched inside the ``encode.audio`` spans
of the traced pass (the audio tower: fbank, BEATs, then the Q-Former and
projection or the audio projector).  Nothing to read unless the spans
count one per batch."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("encode.audio")
    if (not span or span["device_s"] <= 0 or not tr["clips"]
            or span["count"] != len(tr["batches"])):
        return None
    return span["device_s"] / tr["clips"] * 1e3
