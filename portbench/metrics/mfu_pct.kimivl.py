"""The window's matmul FLOPs at the shapes the program ran
(``portbench/flops_mla_moe.py``: the towers, the latent attention, the
chosen and shared experts, the dense layer, the lm_head) over its wall
seconds times the card's dense bf16 peak."""

from portbench import flops, flops_mla_moe


def read(record):
    w = record["window"]
    if w["seconds"] <= 0 or not w["batch_stats"]:
        return None
    try:
        peak, _ = flops.peaks_for(record["device_name"])
    except KeyError:          # no card with a known peak: nothing to read
        return None
    cfg = record["config"]
    data = cfg["program"]["data"]
    work = sum(flops_mla_moe.batch_flops(cfg["videollama"], data["audio"], data["n_frms"],
                                         w["clips_per_batch"], b["prefix_len"], b["decode_steps"])
               for b in w["batch_stats"])
    return work / (w["seconds"] * peak) * 100.0
