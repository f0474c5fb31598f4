"""The flash kernel's (``csrc/flash_attention.cu``) share of its roofline
in the traced pass: the least time its launches' work needs
(``flops.flash_work``: one causal launch per layer over each batch's
prefix) over its device time.  Nothing to read when the pass launched no
flash kernel, or not one per layer and batch."""

from portbench import flops, trace

KERNEL = "flash_fwd_kernel"


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    seconds, launches = trace.kernel_time(tr, KERNEL)
    cfg = record["config"]
    llm = cfg["videollama"]["llm"] if "videollama" in cfg else cfg["program"]["model"]["llm"]
    batch = record["window"]["clips_per_batch"]
    if not launches or launches != llm["num_layers"] * len(tr["batches"]):
        return None
    hd = llm["hidden_size"] // llm["num_heads"]
    least = sum(llm["num_layers"] * flops.least_seconds(
        *flops.flash_work(batch, llm["num_heads"], llm["num_kv_heads"], b["prefix_len"], hd),
        record["device_name"]) for b in tr["batches"])
    return least / seconds * 100.0
