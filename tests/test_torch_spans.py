"""The program's profiler spans (``utils/profiling.py``) in a
``torch.profiler`` trace of one tiny ``run_inference`` pass on the CPU,
for each backbone and each decoder: every span is there, opened on the
one thread that launches the work, the tower spans nest inside
``encode`` and the pass spans inside ``decode``, the spans count what
the pass did, and tracing changes no token, record or stat."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mraudio_tpu_torch.config import RunConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.infer.evaluate import build_model, run_inference

SPANS = ("load", "encode", "encode.video", "encode.audio", "prefill", "decode", "decode.pass",
         "decode.sync")
NESTED = (("encode.video", "encode"), ("encode.audio", "encode"), ("decode.pass", "decode"),
          ("decode.sync", "decode"))
CASES = {
    "greedy": ("X-InstructBLIP", {}),
    "grammar": ("X-InstructBLIP", {"constrained_decoding": True}),
    "lookup": ("X-InstructBLIP", {"lookup_spec": 4}),
    "videollama": ("VideoLLaMA", {}),
}


def _annotations(n=3):
    """Two batches of 2, the second padded."""
    return [{"vid": f"v{i}", "qid": i, "query": f"a person does action {i}",
             "duration": 150 - 7 * i, "relevant_windows": [[10 + i, 30 + i]]}
            for i in range(n)]


def _pass(cfg, model, trace_path=None):
    """One ``run_inference`` pass; returns its result and every batch's
    generated ids as ``generate_finalize`` received them."""
    kept, finalize = [], model.generate_finalize

    def keep(pending, **kwargs):
        kept.append((pending[0] if isinstance(pending, tuple) else pending).clone())
        return finalize(pending, **kwargs)

    model.generate_finalize = keep
    try:
        kwargs = dict(model=model, annotations=_annotations(), batch_size=2, num_workers=2,
                      device="cpu")
        if trace_path is None:
            res = run_inference(cfg, **kwargs)
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                res = run_inference(cfg, **kwargs)
            prof.export_chrome_trace(str(trace_path))
    finally:
        del model.generate_finalize
    return res, torch.cat(kept)


def _spans(path) -> dict:
    """``{name: [(start, end, thread), ...]}`` of the program's spans."""
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in SPANS:
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"], e["tid"]))
    return out


def _counted(stats: list) -> list:
    """The batch stats without their host seconds."""
    return [{k: v for k, v in b.items() if not k.endswith("_s")} for b in stats]


@pytest.mark.parametrize("case", list(CASES))
def test_spans_count_the_pass_and_change_nothing(case, tmp_path):
    name, changes = CASES[case]
    cfg = RunConfig(model_name=name, model=tiny_model_config().replace(**changes),
                    data=tiny_data_config(n_frms=4))
    model = build_model(cfg, device="cpu")
    plain, plain_ids = _pass(cfg, model)
    traced, traced_ids = _pass(cfg, model, tmp_path / "trace.json")
    assert torch.equal(plain_ids, traced_ids)
    assert plain["records"] == traced["records"]
    assert _counted(plain["batches"]) == _counted(traced["batches"])

    spans = _spans(tmp_path / "trace.json")
    assert set(spans) == set(SPANS)
    # no loader worker opens a span
    assert len({tid for ivals in spans.values() for _, _, tid in ivals}) == 1
    for inner, outer in NESTED:
        assert all(any(a0 <= a and z <= z0 for a0, z0, _ in spans[outer])
                   for a, z, _ in spans[inner]), (inner, outer)

    batches = traced["batches"]
    steps = [b["decode_steps"] for b in batches]
    budget = model.cfg.max_new_tokens
    assert len(batches) == 2 and all(steps)
    assert len(spans["load"]) == len(batches) + 1
    assert len(spans["decode.pass"]) == sum(steps)
    # one check per pass, and one more where the rows finish early
    assert len(spans["decode.sync"]) == sum(s + (s < budget) for s in steps)
    for span in ("encode", "encode.video", "encode.audio", "prefill", "decode"):
        assert len(spans[span]) == len(batches), span
