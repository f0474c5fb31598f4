"""Wall milliseconds per decode pass inside the ``decode.pass`` spans of
the traced pass: the host's time to launch one model pass and its token
bookkeeping.  Nothing to read unless the spans count the batches' summed
``decode_steps``."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("decode.pass")
    passes = sum(b.get("decode_steps", 0) for b in tr["batches"]) if tr else 0
    if not span or not passes or span["count"] != passes:
        return None
    return span["wall_s"] / passes * 1e3
