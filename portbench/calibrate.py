"""Readings that set a cell's ``correct`` limits, on the chip at the
cell's own size: the program's sound runs over many seeds, and the
control's over a few.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--out F.json]

One process: the model is built and warmed once; for each seed its
weights are seeded anew, a window of one whole batch of that seed's
clips runs through the cell's entry (as many clips as a run compares)
and the reference scores them.  The control is the program with the cell's
``control`` decoder settings switched on (a lower-precision path of its
own), on the same clips and seeded weights (int8 weights quantized from
them per output channel).  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _set_llm(model, changes: dict) -> None:
    from mraudio_tpu_torch.config import LlamaConfig

    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), LlamaConfig):
            m.cfg = m.cfg.replace(**changes)


def _int8_fill_(model, spec: list, seed: int) -> None:
    """``model`` (built with int8 decoder weights) filled from the sound
    spec's seeded weights: every decoder projection's float kernel
    quantized per output channel (absmax / 127, the program's
    ``quantize_llama_int8`` rule), every other leaf copied."""
    import torch

    from portbench import weights

    src = weights.make(spec, seed, next(model.parameters()).device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            if name.endswith(".w_int8") or (name.endswith(".scale")
                                            and name[:-5] + "w_int8" in params):
                kernel = src[name.rsplit(".", 1)[0] + ".kernel"].float()
                scale = kernel.abs().amax(0) / 127.0
                scale = torch.where(scale == 0, 1.0, scale)
                p.copy_(torch.round(kernel / scale).to(torch.int8) if name.endswith("w_int8")
                        else scale)
            else:
                p.copy_(src[name])
    del src


def readings(ctx, seeds, control_seeds, controls=None) -> dict:
    from portbench import weights
    from portbench.entries import run_inference as entry

    ctx.cell = dict(ctx.cell, window_batches=1)
    state = entry.setup(ctx)
    spec = state["spec"]
    out = {"sound": [], "control": []}
    # the decoder settings that keep the weights first; int8 weights need a
    # model of their own, built after the sound runs
    controls = sorted(controls or [ctx.cell["control"]], key=lambda c: "quantization" in c)
    base = {k: getattr(state["model"].llm.cfg, k) for c in controls for k in c}
    for kind, seeds_, changes in [("sound", seeds, {})] + [("control", control_seeds, c)
                                                           for c in controls]:
        quantized = changes.get("quantization", base.get("quantization")) != base.get(
            "quantization")
        if quantized:
            model = state.pop("model")
            del model, state["capture"]
            entry._free(ctx.device)
            state["run_cfg"], state["model"] = entry._build(ctx.config, ctx.device,
                                                            dict(base, **changes))
            state["capture"] = entry._Capture(state["model"],
                                              logits="logit_rel_err" in ctx.cell["limits"])
        else:
            _set_llm(state["model"], dict(base, **changes))
        for seed in seeds_:
            ctx.seed = seed
            if quantized:
                _int8_fill_(state["model"], spec, seed)
            else:
                weights.fill_module_(state["model"], seed)
            t = time.perf_counter()
            win = entry.window(ctx, state)
            sample = entry.score(ctx, spec, win)
            row = {"seed": seed, "control": changes, "gap": max(sample["gaps"]),
                   "mean_gap": sample["mean_gap"], "rel_err": sample["rel_err"],
                   "gaps": sample["gaps"], "tokens": sample["tokens"],
                   "text_mismatch": win["text_mismatch"],
                   "pass_s": win["record"]["window"]["seconds"],
                   "seconds": time.perf_counter() - t}
            print(kind, json.dumps(row), flush=True)
            out[kind].append(row)
    return out


def main(argv=None) -> int:
    import torch

    from portbench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="",
                   help="JSON list of decoder settings to read as controls (default: the "
                        "cell's own control)")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    control = [int(s) for s in a.control_seeds.split(",") if s]
    ctx = harness.context(harness.PACKAGE, a.workload, seeds[0], False,
                          torch.device("cuda", 0), T0,
                          str(harness.PACKAGE.parent / "build" / "portbench"))
    result = readings(ctx, seeds, control, json.loads(a.controls) if a.controls else None)
    result.update(workload=a.workload, device=torch.cuda.get_device_name(0))
    for key in ("gap", "mean_gap", "rel_err"):
        result[f"lower_{key}"] = max(r[key] for r in result["sound"])
        for c in {json.dumps(r["control"], sort_keys=True) for r in result["control"]}:
            result[f"upper_{key} {c}"] = min(r[key] for r in result["control"]
                                             if json.dumps(r["control"], sort_keys=True) == c)
    print(json.dumps({k: v for k, v in result.items() if k not in ("sound", "control")}))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
