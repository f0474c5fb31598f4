"""Wall milliseconds per decode pass inside the ``decode.sync`` spans of
the traced pass: the host blocked on the per-pass check that every row
has finished, waiting for the device.  A batch checks once per pass and
once more when its rows finish before the token budget; nothing to read
when the spans count otherwise."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("decode.sync")
    if not span or not tr["batches"]:
        return None
    cfg = record["config"]
    budget = (cfg["videollama"] if "videollama" in cfg
              else cfg["program"]["model"])["max_new_tokens"]
    steps = [b.get("decode_steps", 0) for b in tr["batches"]]
    if not sum(steps) or span["count"] != sum(s + (s < budget) for s in steps):
        return None
    return span["wall_s"] / sum(steps) * 1e3
