"""Host milliseconds per batch in ``run_inference``'s ``parse_write`` stage
(``generate_finalize``'s detokenization and span parsing, the records),
over the untraced window."""


def read(record):
    w = record["window"]
    return w["parse_write_s"] / w["batches"] * 1e3 if w["batches"] else None
