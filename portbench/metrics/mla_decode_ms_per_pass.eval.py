"""Device milliseconds per decode pass launched inside the ``mla.decode``
spans of the traced pass: every layer's latent attention over the latent
cache.  Nothing to read unless the spans count one per decoder layer and
pass (the layers times the batches' summed ``decode_steps``)."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("mla.decode")
    if not span or span["device_s"] <= 0:
        return None
    passes = sum(b.get("decode_steps", 0) for b in tr["batches"])
    layers = record["config"]["videollama"]["llm"]["num_layers"]
    if not passes or span["count"] != layers * passes:
        return None
    return span["device_s"] / passes * 1e3
