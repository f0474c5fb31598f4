"""The Kimi-VL-A3B cell's pieces at tiny size on the CPU: a whole run of the
tiny copy (``tests/data``, ``tiny-kimi-eval``) comes out correct, each
fault of the decoder's mathematics planted where the program computes it
comes out not correct, the spans the new metrics read count as planned,
the readers and ``flops_mla_moe.py`` by hand, and the reference imports
neither JAX nor the port.  Two ``card`` tests: an expert layer's decode
call at full width never waits for the device, and greedy decoding that
replays a CUDA graph of one pass gives the eager loop's tokens.

The tiny copy runs its decoder in float32, so its limit sits just above
what the bf16 prefix leaves (the connector computes in bf16 whatever the
decoder's dtype, the reference in float32), and every run here seeds its
weights with :func:`exercised_weights`: the benchmark's rule, then the
queries and the latent's key and value maps doubled (the attention is
then sharp enough for the rope's pairing to matter), the latent's columns
of ``kv_a_proj_with_mqa`` scaled by 0.03 (its mean square, about 1e-4,
then near the latent norm's eps) and the router's correction bias by 8
(it then moves choices and, added to the weights, moves them).  At the
benchmark's own weights the latent's mean square is about 0.8 at full
width, where 1e-5 against 1e-6 changes nothing a logit comparison sees."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import flops, flops_mla_moe, harness, weights
from portbench.entries import run_inference as entry

SEED = 2 ** 33 + 17
CELL = "tiny-kimi-eval"
FAULTS = ("softmax_scores", "bias_left_out_of_choice", "bias_added_to_weights",
          "no_renormalisation", "no_routed_scale", "rope_halves", "latent_norm_skipped",
          "latent_norm_eps_1e-5", "shared_experts_dropped")


@pytest.fixture
def exercised_weights(monkeypatch):
    fill = weights.fill_

    def fill_(tensors, seed):
        out = fill(tensors, seed)
        with torch.no_grad():
            for name, t in out.items():
                if name.endswith(("attn.q_proj.kernel", "attn.kv_b_proj.kernel")):
                    t.mul_(2.0)
                elif name.endswith("attn.kv_a_proj_with_mqa.kernel"):
                    t[:, :-8].mul_(0.03)              # the latent; the last 8 are the rope key
                elif name.endswith("mlp.router.bias"):
                    t.mul_(8.0)
        return out

    monkeypatch.setattr(weights, "fill_", fill_)


def _bench():
    bench = json.loads((harness.PACKAGE.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    return bench


def _run(data_root, seed=SEED):
    return harness.execute(data_root, _bench(), CELL, seed, False, torch.device("cpu"),
                           time.perf_counter(), "build/portbench-test")


@pytest.mark.parametrize("seed", [SEED, SEED + 1, 2 ** 31 + 5])
def test_sound_tiny_run_is_correct(data_root, exercised_weights, seed):
    rc, line = _run(data_root, seed)
    assert rc == 0 and line["correct"], line["checks"]
    assert line["attempted"] == 4 and line["failed"] == 0


def _plant(monkeypatch, fault: str) -> None:
    from mraudio_tpu_torch.models import layers, mla, moe

    def router(self, x2):
        cfg = self.cfg
        logits = x2.float() @ self.kernel.float()
        scores = logits.softmax(-1) if fault == "softmax_scores" else logits.sigmoid()
        bias = self.bias.float()
        choice = scores if fault == "bias_left_out_of_choice" else scores + bias
        ids = choice.topk(cfg.num_experts_per_tok, dim=-1, sorted=False).indices
        w = (scores + bias if fault == "bias_added_to_weights" else scores).gather(1, ids)
        if fault != "no_renormalisation":
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return ids, w * (1.0 if fault == "no_routed_scale" else cfg.routed_scaling_factor)

    class Skipped(layers.RMSNorm):
        def forward(self, x):
            return x

    class Dropped(moe.LlamaMlp):
        def forward(self, x, *args, **kwargs):
            return torch.zeros_like(x)

    if fault in ("softmax_scores", "bias_left_out_of_choice", "bias_added_to_weights",
                 "no_renormalisation", "no_routed_scale"):
        monkeypatch.setattr(moe.Router, "forward", router)
    elif fault == "rope_halves":
        monkeypatch.setattr(mla, "deinterleave", lambda x: x)
    elif fault == "latent_norm_skipped":
        monkeypatch.setattr(mla, "RMSNorm", Skipped)
    elif fault == "latent_norm_eps_1e-5":
        monkeypatch.setattr(mla, "LATENT_NORM_EPS", 1e-5)
    else:
        monkeypatch.setattr(moe, "LlamaMlp", Dropped)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_fails(data_root, exercised_weights, monkeypatch, fault):
    _plant(monkeypatch, fault)
    rc, line = _run(data_root)
    assert rc == 0 and not line["correct"]
    check = line["checks"]["logit_rel_err"]
    assert check["value"] > check["limit"]


def test_traced_spans_count_as_planned(data_root, exercised_weights):
    """One span per layer and pass: ``mla.*`` in all 3 layers, ``moe.*`` in
    the 2 after the dense one."""
    ctx = harness.context(data_root, CELL, SEED, True, torch.device("cpu"),
                          time.perf_counter(), "build/portbench-test")
    out = entry.run(ctx)
    tr = out["record"]["trace"]
    passes = sum(b["decode_steps"] for b in tr["batches"])
    batches = len(tr["batches"])
    counts = {k: tr["spans"][k]["count"] for k in ("mla.prefill", "moe.prefill", "mla.decode",
                                                    "moe.decode")}
    assert counts == {"mla.prefill": 3 * batches, "moe.prefill": 2 * batches,
                      "mla.decode": 3 * passes, "moe.decode": 2 * passes}


def test_traced_tiny_run_reports_the_shared_host_metrics(data_root, exercised_weights):
    """The readers the cell shares with the dense cells find their spans in
    the expert decoder's traced pass (the device readers find no device
    time on the CPU)."""
    bench = _bench()
    rc, line = harness.execute(data_root, bench, CELL, SEED, True, torch.device("cpu"),
                               time.perf_counter(), "build/portbench-test")
    assert rc == 0 and line["correct"], line["checks"]
    host = ("load_ms.eval", "decode_launch_ms_per_pass.eval", "decode_sync_ms_per_pass.eval",
            "decode_ms_per_pass.eval", "parse_write_ms.eval")
    assert all(line["metrics"][name]["value"] > 0 for name in host), line["metrics"]


KIMI = {"videollama": {"llm": {"num_layers": 27, "first_k_dense_replace": 1}}}


def _record(**spans):
    return {"trace": {"spans": spans, "clips": 8,
                      "batches": [{"decode_steps": 64}, {"decode_steps": 10}]},
            "config": KIMI}


def _read(name, record):
    return harness.read_metric(harness.PACKAGE, name, record)


def test_span_readers_by_hand():
    span = lambda device_s, count: {"device_s": device_s, "wall_s": 2 * device_s, "count": count}
    r = _record(**{"mla.prefill": span(1.6, 54), "moe.prefill": span(0.8, 52),
                   "mla.decode": span(0.74, 27 * 74), "moe.decode": span(1.48, 26 * 74)})
    assert _read("mla_prefill_ms.eval", r) == pytest.approx(200.0)      # 1.6 s over 8 clips
    assert _read("moe_prefill_ms.eval", r) == pytest.approx(100.0)
    assert _read("mla_decode_ms_per_pass.eval", r) == pytest.approx(10.0)  # 0.74 s over 74
    assert _read("moe_decode_ms_per_pass.eval", r) == pytest.approx(20.0)
    # nothing to read: no span, no device time, or a count off the plan
    for name in ("mla_prefill_ms.eval", "moe_prefill_ms.eval", "mla_decode_ms_per_pass.eval",
                 "moe_decode_ms_per_pass.eval"):
        assert _read(name, _record()) is None
        assert _read(name, {"trace": None, "config": KIMI}) is None
    zero = _record(**{"mla.prefill": span(0.0, 54), "mla.decode": span(0.0, 27 * 74)})
    assert _read("mla_prefill_ms.eval", zero) is None
    assert _read("mla_decode_ms_per_pass.eval", zero) is None
    off = _record(**{"mla.decode": span(0.74, 27 * 74 - 1), "moe.decode": span(1.48, 27 * 74)})
    assert _read("mla_decode_ms_per_pass.eval", off) is None
    assert _read("moe_decode_ms_per_pass.eval", off) is None


TINY_LLM = dict(hidden_size=8, num_layers=2, num_heads=2, kv_lora_rank=4, qk_nope_head_dim=3,
                qk_rope_head_dim=2, v_head_dim=5, n_routed_experts=4, num_experts_per_tok=2,
                n_shared_experts=1, moe_intermediate_size=6, first_k_dense_replace=1,
                intermediate_size=10, vocab_size=11)


def test_decoder_flops_by_hand():
    """Two rows' worth at S = 3 prefix tokens and 2 decode passes, counted
    product by product (2 FLOPs per multiply-add)."""
    d, h, r, nope, rope, vd = 8, 2, 4, 3, 2, 5
    proj = 2 * d * h * (nope + rope) + 2 * d * (r + rope) + 2 * h * vd * d  # q, kv_a, o
    dense = 3 * 2 * d * 10
    expert = 2 * d * 4 + 3 * 2 * d * 6 * (2 + 1)          # router, 2 chosen + 1 shared
    per_token = 2 * proj + dense + expert
    head = 2 * d * 11
    s, p = 3, 2
    prefill = s * per_token + 2 * (s * 2 * r * h * (nope + vd)      # kv_b per column
                                   + 6 * 2 * h * (nope + rope + vd))  # 6 causal pairs
    absorb = 2 * h * nope * r + 2 * h * r * vd
    columns = (s + 1) + (s + 2)
    decode = p * (per_token + 2 * absorb + head) + 2 * columns * 2 * h * (2 * r + rope)
    assert flops_mla_moe.decoder_flops(TINY_LLM, s, p) == prefill + head + decode


def test_batch_flops_add_the_towers(data_root):
    cfg = harness.load(data_root, "configs", "tiny-kimi")
    model, data = cfg["videollama"], cfg["program"]["data"]
    whole = flops_mla_moe.batch_flops(model, data["audio"], data["n_frms"], 2, 40, 8)
    towers = flops.videollama_flops(model, data["audio"], data["n_frms"], 2, 40, 8) - sum(
        flops._decoder(model["llm"], 2, 40, 8))
    assert whole == pytest.approx(towers + 2 * flops_mla_moe.decoder_flops(model["llm"], 40, 8))
    rec = {"window": {"seconds": 2.0, "clips_per_batch": 2,
                      "batch_stats": [{"prefix_len": 40, "decode_steps": 8}] * 3},
           "config": cfg, "device_name": "NVIDIA H100 80GB HBM3"}
    assert _read("mfu_pct.kimivl", rec) == pytest.approx(3 * whole / (2.0 * 989e12) * 100)
    assert _read("mfu_pct.kimivl", dict(rec, device_name="cpu")) is None


def test_the_reference_imports_neither_jax_nor_the_port():
    path = harness.PACKAGE / "reference" / "videollama_mla_moe.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "torch", "portbench"}
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.videollama_mla_moe;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'mraudio_tpu', 'mraudio_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.PACKAGE.parent,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_an_expert_decode_layer_never_waits_for_the_device(card):
    """One expert layer at full width (64 experts of 1408, 6 per token, 2
    shared), a decode call of 4 rows, under the sync debug mode 'error':
    any synchronisation with the host inside the layer would raise."""
    from mraudio_tpu_torch.config import LlamaConfig
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.moe import ExpertCounters, MoeMlp
    from mraudio_tpu_torch.ops import build

    cfg = harness.load(harness.PACKAGE, "configs", "kimi-vl-a3b-av")["videollama"]["llm"]
    build.build_all()
    with torch.device(card):
        layer = cast_params_for_inference(MoeMlp(LlamaConfig.from_dict(cfg)))
    weights.fill_module_(layer, 5)
    layer.counters = ExpertCounters()
    x = torch.randn(4, 1, 2048, device=card, dtype=torch.bfloat16)
    with torch.inference_mode():
        layer(x, decode=True)                      # first call: handles and kernels load
        torch.cuda.synchronize(card)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                y = layer(x, decode=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(card)
    assert y.shape == (4, 1, 2048) and torch.isfinite(y.float()).all()
    assert 6 <= layer.counters.read()["moe_decode_experts"] <= 24


@pytest.mark.card
def test_a_replayed_decode_gives_the_eager_tokens(card):
    """The decoder at full width with 3 of its layers (1 dense, 2 with
    experts), bf16, its routes as the configuration sets them: 4
    left-padded rows of up to 300 tokens decoded greedily for 16 passes by
    replaying a CUDA graph of one pass and by the eager loop give the same
    tokens and routing counters, and the replays launch no GEMV from the
    host."""
    from mraudio_tpu_torch.config import LlamaConfig
    from mraudio_tpu_torch.infer.generate import greedy_generate
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.llama import LlamaModel
    from mraudio_tpu_torch.ops import build
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    cfg = harness.load(harness.PACKAGE, "configs", "kimi-vl-a3b-av")["videollama"]["llm"]
    build.build_all()
    with torch.device(card):
        model = cast_params_for_inference(LlamaModel(LlamaConfig.from_dict(
            dict(cfg, num_layers=3))))
    weights.fill_module_(model, 11)
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(4, 300, 2048, generator=gen, device=card).to(torch.bfloat16)
    mask = torch.ones(4, 300, dtype=torch.int32, device=card)
    for b, pad in enumerate((0, 40, 120, 299)):
        mask[b, :pad] = 0
    runs = {}
    for graph in (True, False, True):
        model.decode_graph = graph
        stats, launches = {}, decode_gemv.launches
        torch.cuda.synchronize(card)
        t = time.perf_counter()
        tokens = greedy_generate(model, x, mask, 16, eos_id=-1, stats=stats)
        torch.cuda.synchronize(card)
        runs.setdefault(graph, []).append((tokens.cpu(), stats, decode_gemv.launches - launches,
                                           time.perf_counter() - t))
    eager = runs[False][0]
    print("decode_s graph", [r[1]["decode_s"] for r in runs[True]], "eager", eager[1]["decode_s"])
    for tokens, stats, launches, _ in runs[True]:
        assert torch.equal(tokens, eager[0])
        for key in ("decode_steps", "moe_decode_experts", "moe_prefill_imbalance"):
            assert stats[key] == eager[1][key], key
        # the prefill's, the first pass's and the capture's host launches only
        assert launches < eager[2]
