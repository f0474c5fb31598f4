"""The GEMV kernel's (``csrc/decode_gemv.cu``) share of its roofline in the
traced pass: the least time its launches' work needs (``flops.gemv_work``
at each launch's shape: a decode pass's seven projections per layer and
the lm_head, plus the prefill's last-position lm_head, all at the batch's
rows) over its device time.  Nothing to read when the launch count does
not match that plan."""

from portbench import flops, trace

KERNEL = "gemv_kernel"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    seconds, launches = trace.kernel_time(tr, KERNEL)
    if not launches:
        return None
    cfg = record["config"]
    llm = cfg["videollama"]["llm"] if "videollama" in cfg else cfg["program"]["model"]["llm"]
    rows = record["window"]["clips_per_batch"]
    wbytes = 1 if llm["quantization"] == "int8" else 2
    dev = record["device_name"]

    def least(k, n):
        return flops.least_seconds(*flops.gemv_work(rows, k, n, wbytes if (k, n) != (
            llm["hidden_size"], llm["vocab_size"]) else 2), dev)

    layer = sum(least(k, n) for k, n in flops.decoder_gemv_shapes(llm))
    head = least(llm["hidden_size"], llm["vocab_size"])
    passes = sum(b["decode_steps"] for b in tr["batches"])
    planned = passes * (7 * llm["num_layers"] + 1) + len(tr["batches"])
    if launches != planned:
        return None
    total = passes * (llm["num_layers"] * layer + head) + len(tr["batches"]) * head
    return total / seconds * 100.0
