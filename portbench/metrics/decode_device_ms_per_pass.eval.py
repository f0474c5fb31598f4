"""Device milliseconds per decode pass launched inside the ``decode.pass``
spans of the traced pass.  Nothing to read unless the spans count the
batches' summed ``decode_steps``."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("decode.pass")
    passes = sum(b.get("decode_steps", 0) for b in tr["batches"]) if tr else 0
    if not span or span["device_s"] <= 0 or not passes or span["count"] != passes:
        return None
    return span["device_s"] / passes * 1e3
