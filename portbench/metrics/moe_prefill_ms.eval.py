"""Device milliseconds per clip launched inside the ``moe.prefill`` spans of
the traced pass: every expert layer over the prefix (router, dispatch,
grouped expert products, shared experts, combine).  Nothing to read when
the pass opened no such span."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("moe.prefill")
    if not span or span["device_s"] <= 0 or not tr["clips"]:
        return None
    return span["device_s"] / tr["clips"] * 1e3
