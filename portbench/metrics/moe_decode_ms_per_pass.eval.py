"""Device milliseconds per decode pass launched inside the ``moe.decode``
spans of the traced pass: every expert layer of the pass.  Nothing to
read unless the spans count one per expert layer (the layers from
``first_k_dense_replace`` on) and pass."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("moe.decode")
    if not span or span["device_s"] <= 0:
        return None
    passes = sum(b.get("decode_steps", 0) for b in tr["batches"])
    llm = record["config"]["videollama"]["llm"]
    if not passes or span["count"] != (llm["num_layers"] - llm["first_k_dense_replace"]) * passes:
        return None
    return span["device_s"] / passes * 1e3
