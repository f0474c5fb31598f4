"""Device milliseconds per clip launched inside the ``mla.prefill`` spans of
the traced pass: every layer's latent attention over the prefix (its
projections, the decompression through ``kv_b_proj``, ``chunked_attention``).
Nothing to read when the pass opened no such span."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("mla.prefill")
    if not span or span["device_s"] <= 0 or not tr["clips"]:
        return None
    return span["device_s"] / tr["clips"] * 1e3
