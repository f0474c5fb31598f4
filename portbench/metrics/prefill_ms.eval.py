"""Device milliseconds per clip launched inside the ``prefill`` spans of
the traced pass (the decoder over the whole prefix, writing the cache)."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("prefill")
    if not span or span["device_s"] <= 0 or not tr["clips"]:
        return None
    return span["device_s"] / tr["clips"] * 1e3
