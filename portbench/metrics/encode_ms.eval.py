"""Device milliseconds per clip launched inside the ``encode`` spans of the
traced pass (preprocessing, the encoders, the Q-Formers or the connector,
the interleave)."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("encode")
    if not span or span["device_s"] <= 0 or not tr["clips"]:
        return None
    return span["device_s"] / tr["clips"] * 1e3
