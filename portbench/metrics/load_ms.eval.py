"""Wall milliseconds per batch inside the ``load`` spans of the traced
pass: the time ``run_inference`` waited for the loader's next batch to be
built and copied to the device.  Nothing to read unless the spans count
one per batch and one more for the end of the stream."""


def read(record):
    tr = record.get("trace")
    span = (tr or {}).get("spans", {}).get("load")
    if not span or not tr["batches"] or span["count"] != len(tr["batches"]) + 1:
        return None
    return span["wall_s"] / len(tr["batches"]) * 1e3
