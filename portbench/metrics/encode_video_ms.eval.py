"""Device milliseconds per clip launched inside the ``encode.video`` spans
of the traced pass (the video tower: wire decode, normalisation, the ViT,
then the Q-Former and projection or the connector).  Nothing to read
unless the spans count one per batch."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("encode.video")
    if (not span or span["device_s"] <= 0 or not tr["clips"]
            or span["count"] != len(tr["batches"])):
        return None
    return span["device_s"] / tr["clips"] * 1e3
