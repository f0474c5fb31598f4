"""The port's serving path against the JAX package: the continuous
batcher (``infer/serving.py``) and the serve CLI (``cli/serve.py``).

Engine: the tiny decoder in f32 with int8 weights and an int8 KV cache,
the JAX weights carried across with ``load_jax_params_``, the same
numpy-seeded prefixes through both packages' engines.  Every contract of
the reference's serving tests must hold with identical tokens: each
request's tokens equal JAX's engine's and the port's own batched
``greedy_generate``'s (up to the request's end), under every admission,
dispatch, speculation, pipelining, compaction and cancellation setting.
CLI: ``serve()`` records equal JAX's with the latency field removed,
in burst and load mode; the CLI's flags do not change the records.  No
tolerance anywhere: tokens and records are compared exactly."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.cli.serve import encode_requests as j_encode_requests
from mraudio_tpu.cli.serve import poisson_arrivals as j_poisson_arrivals
from mraudio_tpu.cli.serve import serve as j_serve
from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.data.dataset import MRDataset as JDataset
from mraudio_tpu.infer.serving import ContinuousBatcher as JBatcher
from mraudio_tpu.infer.serving import Request as JRequest
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu_torch.cli import serve as cli_serve
from mraudio_tpu_torch.config import LlamaConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.data.dataset import MRDataset
from mraudio_tpu_torch.infer.generate import greedy_generate
from mraudio_tpu_torch.infer.serving import ContinuousBatcher, Request
from mraudio_tpu_torch.models.casting import cast_params_for_inference
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.llama import LlamaModel
from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP

torch.set_num_threads(1)

S, NEW = 12, 6
BASE = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
            intermediate_size=128, max_seq_len=256, dtype="float32", prefill_chunk=0,
            quantization="int8", kv_quant="int8")
KEEP = dict(kv_keep=8, kv_keep_obs=4, kv_keep_sink=2)


def _refill(tree, rng):
    """The flax init leaves int8 weights at 0 (and LoRA's B at 0)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _refill(v, rng)
            if "w_int8" in v:
                out[k]["w_int8"] = rng.integers(-127, 128, v["w_int8"].shape).astype(np.int8)
                out[k]["scale"] = (rng.uniform(0.5, 1.5, v["w_int8"].shape[1])
                                   * (0.05 / 73.6)).astype(np.float32)
        elif k == "lora_b":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _random_tree(shapes, rng, std=0.02):
    """Seeded weights for a tree of shapes (the flax init is slow at this
    size): int8 weights uniform with per-column scales, norm scales 1,
    biases 0, everything else N(0, std)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _random_tree(v, rng, std)
            if "w_int8" in v:
                out[k]["scale"] = (rng.uniform(0.5, 1.5, v["w_int8"].shape[1])
                                   * (0.05 / 73.6)).astype(np.float32)
        elif v.dtype == np.int8:
            out[k] = rng.integers(-127, 128, v.shape).astype(np.int8)
        elif k in ("scale", "grep_a"):
            out[k] = np.ones(v.shape, np.float32)
        elif k == "bias":
            out[k] = np.zeros(v.shape, np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) * std).astype(np.float32)
    return out


def _prefixes(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones(S, np.int32)
        mask[:i % 3] = 0                                   # varying left padding
        out.append((rng.standard_normal((S, 64)).astype(np.float32), mask))
    return out


class Setup:
    """The JAX params, a per-config cache of both packages' models, the
    prefixes and an EOS id that ends some rows early."""

    def __init__(self):
        jm = JLlama(JLlamaConfig(**BASE), None)
        params = jax.device_get(jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)), jnp.ones((1, 1, 8, 8), bool),
            jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32),
            method=JLlama.init_all)["params"])
        self.params = _refill(params, np.random.default_rng(0))
        self.prefixes = _prefixes(5, seed=1)
        self._models = {}
        self.jax_runs = {}
        # an id the base model emits mid-sequence in some rows, so that
        # requests end at different steps and slots free and refill
        free = self.greedy({}, 259)
        self.eos = int(free[1, 2])
        assert (free[:, :NEW] == self.eos).any(axis=1).sum() >= 2

    def models(self, changes: dict):
        key = tuple(sorted(changes.items()))
        if key not in self._models:
            cfg = dict(BASE, **changes)
            self._models[key] = (JLlama(JLlamaConfig(**cfg), None),
                                 load_jax_params_(LlamaModel(LlamaConfig(**cfg)), self.params))
        return self._models[key]

    def greedy(self, changes: dict, eos: int) -> np.ndarray:
        x = torch.from_numpy(np.stack([e for e, _ in self.prefixes]))
        m = torch.from_numpy(np.stack([k for _, k in self.prefixes]))
        return greedy_generate(self.models(changes)[1], x, m, NEW, eos).numpy()

    def requests(self, request_type, hints: bool = False, prefixes=None):
        hint = np.arange(3, 40, dtype=np.int32)
        return [request_type(i, e, m, hint_ids=hint if hints else None)
                for i, (e, m) in enumerate(prefixes or self.prefixes)]


@pytest.fixture(scope="module")
def setup():
    return Setup()


def _drive(engine, reqs, mode: str = "batched", cancel_id=None):
    """Run ``reqs`` through an engine (either package's): ``batched``
    admits what fits with ``submit_many``, ``sequential`` one ``submit``
    at a time, ``interleaved`` one admission stage per loop iteration with
    decode passes between them.  ``cancel_id`` is cancelled once it has
    emitted a token."""
    pending, results = list(reqs), {}
    while (pending or engine.active.any() or engine._inflight
           or engine.admission_pending()):
        if mode == "interleaved":
            if engine.admission_pending():
                engine.admission_step()
            elif pending and engine.free_slots():
                del pending[:engine.begin_admission(pending)]
        elif pending and engine.free_slots():
            if mode == "batched":
                del pending[:engine.submit_many(pending)]
            elif engine.submit(pending[0]):
                pending.pop(0)
        if engine.active.any() or engine._inflight:
            for c in engine.step():
                results[c.request_id] = list(c.token_ids)
        if cancel_id is not None:
            for i in range(engine.max_slots):
                if engine.slot_request[i] == cancel_id and engine.emitted[i]:
                    assert engine.cancel(cancel_id)
                    cancel_id = None
    return results


def _check_greedy(results, ref, eos, ids):
    assert sorted(results) == sorted(ids)
    for rid, tokens in results.items():
        want = ref[rid].tolist()
        assert tokens == want[:len(tokens)], rid
        assert len(tokens) == NEW or tokens[-1] == eos, rid


# name: (model changes, engine settings, driving mode, hints, the JAX run
# it is held to).  JAX's own tests hold its engine's settings to one
# another; the JAX engine runs here once per model configuration and
# speculative path, and each port setting must give those tokens.
CASES = {
    "batched": ({}, dict(max_slots=2), "batched", False, "batched"),
    "sequential": ({}, dict(max_slots=2), "sequential", False, "batched"),
    "submit_many_bucket": ({}, dict(max_slots=4, max_prefill_batch=3), "batched", False,
                           "batched"),
    "steps_per_dispatch_2": ({}, dict(max_slots=2, steps_per_dispatch=2), "batched", False,
                             "batched"),
    "pipeline_depth_1": ({}, dict(max_slots=2, pipeline_depth=1), "batched", False, "batched"),
    "pipeline_window_3": ({}, dict(max_slots=2, steps_per_dispatch=3), "batched", False,
                          "batched"),
    "spec_2": ({}, dict(max_slots=3, spec_width=2), "batched", False, "spec_4_hints"),
    "spec_4": ({}, dict(max_slots=3, spec_width=4), "batched", False, "spec_4_hints"),
    "spec_4_hints": ({}, dict(max_slots=2, spec_width=4), "batched", True, "spec_4_hints"),
    "interleaved_segments": (dict(prefill_chunk=5), dict(max_slots=2), "interleaved", False,
                             "interleaved_segments"),
    "kv_keep": (KEEP, dict(max_slots=2), "batched", False, "kv_keep"),
    "kv_keep_spec_4": (KEEP, dict(max_slots=2, spec_width=4), "batched", True, "kv_keep_spec_4"),
}


def _jax_run(setup, name):
    if name not in setup.jax_runs:
        changes, kw, mode, hints, _ = CASES[name]
        jm, _ = setup.models(changes)
        setup.jax_runs[name] = _drive(JBatcher(jm, {"params": setup.params}, S, NEW, setup.eos,
                                               **kw), setup.requests(JRequest, hints), mode)
    return setup.jax_runs[name]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_and_greedy(setup, case):
    changes, kw, mode, hints, ref_case = CASES[case]
    _, tm = setup.models(changes)
    eos = setup.eos
    got = _drive(ContinuousBatcher(tm, S, NEW, eos, **kw), setup.requests(Request, hints), mode)
    assert got == _jax_run(setup, ref_case)
    _check_greedy(got, setup.greedy(changes, eos), eos, range(5))


def test_reset_reuse_and_slot_reuse(setup):
    """A reset engine gives a fresh engine's tokens, with other requests
    too; a full engine refuses a submit until a slot frees."""
    _, tm = setup.models({})
    eos = setup.eos
    kw = dict(max_slots=2, max_prefill_batch=2)
    engine = ContinuousBatcher(tm, S, NEW, eos, **kw)
    first = _drive(engine, setup.requests(Request))
    engine.reset()
    assert _drive(engine, setup.requests(Request)) == first
    other = setup.requests(Request, prefixes=_prefixes(3, seed=23))
    engine.reset()
    assert _drive(engine, other) == _drive(ContinuousBatcher(tm, S, NEW, eos, **kw), other)

    engine = ContinuousBatcher(tm, S, 3, eos, max_slots=1)
    reqs = setup.requests(Request)
    assert engine.submit(reqs[0]) and not engine.submit(reqs[1])
    done = engine.run_to_completion()
    assert [c.request_id for c in done] == [0] and engine.free_slots() == 1
    assert engine.submit(reqs[1])
    assert [c.request_id for c in engine.run_to_completion()] == [1]


def test_pipeline_readback_lag_and_drain(setup):
    _, tm = setup.models({})
    engine = ContinuousBatcher(tm, S, 4, 259, max_slots=1, pipeline_depth=2)
    assert engine.submit(setup.requests(Request)[0])
    assert engine.step() == [] and len(engine._inflight) == 1
    out = engine.run_to_completion()
    assert len(out) == 1 and len(out[0].token_ids) == 4 and not engine._inflight


@pytest.mark.parametrize("changes", [{}, KEEP], ids=["plain", "kv_keep"])
def test_cancel_mid_decode_matches_jax(setup, changes):
    """Cancelling request 1 after its first token: no completion for it,
    every other request's tokens as without the cancellation, as in JAX."""
    jm, tm = setup.models(changes)
    eos = setup.eos
    base = _drive(ContinuousBatcher(tm, S, NEW, eos, max_slots=3), setup.requests(Request))
    got = _drive(ContinuousBatcher(tm, S, NEW, eos, max_slots=3), setup.requests(Request),
                 cancel_id=1)
    ref = _drive(JBatcher(jm, {"params": setup.params}, S, NEW, eos, max_slots=3),
                 setup.requests(JRequest), cancel_id=1)
    assert got == ref and 1 not in got
    assert got == {rid: t for rid, t in base.items() if rid != 1}


def test_cancel_mid_admission_and_unknown(setup):
    _, tm = setup.models(dict(prefill_chunk=5))
    engine = ContinuousBatcher(tm, S, 4, setup.eos, max_slots=2)
    assert not engine.cancel(99)
    assert engine.begin_admission(setup.requests(Request)[:2]) == 2
    assert engine.cancel(0)
    while engine.admission_pending():
        engine.admission_step()
    assert 0 not in engine.slot_request and engine.free_slots() == 1
    assert [c.request_id for c in engine.run_to_completion()] == [1]


def test_spec_rejects_steps_per_dispatch(setup):
    _, tm = setup.models({})
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatcher(tm, S, NEW, 2, spec_width=4, steps_per_dispatch=4)
    assert ContinuousBatcher(tm, S, NEW, 2, spec_width=4, pipeline_depth=2).pipeline_depth == 1


def test_draft_for_slot_matches_jax(setup):
    jm, tm = setup.models({})
    engines = (ContinuousBatcher(tm, S, 8, 2, max_slots=1, spec_width=4),
               JBatcher(jm, {"params": setup.params}, S, 8, 2, max_slots=1, spec_width=4))
    for hints, emitted, want in (([1, 5, 9, 8, 7], [], [5, 9, 8, 7]),
                                 ([1, 5, 9, 8, 7], [5, 6, 7], [5, 6, 7, 5]),
                                 ([1, 2, 3], [], [5, 5, 5, 5]),
                                 ([5, 5, 4], [3, 5], [5, 4, 5, 5])):
        drafts = []
        for engine in engines:
            engine.cur_ids[0] = 5
            engine.hints[0] = np.asarray(hints, np.int32)
            engine.emitted[0] = list(emitted)
            drafts.append(engine._draft_for_slot(0))
        assert drafts[0] == drafts[1] == want


def test_poisson_arrivals_match_jax():
    for n, rate, seed in ((10, 2.0, 3), (4, 50.0, 0)):
        got = cli_serve.poisson_arrivals(n, rate, seed)
        assert got == j_poisson_arrivals(n, rate, seed)
        assert got[0] == 0.0 and got == sorted(got)


# ------------------------------------------------------------ serve()

def _annotations(n=4):
    return [{"vid": f"v{i}", "qid": i, "query": f"a person waves {i}", "duration": 60 + 5 * i,
             "relevant_windows": [[5, 12]]} for i in range(n)]


def _f32_int8(cfg):
    return cfg.replace(llm=cfg.llm.replace(dtype="float32", quantization="int8",
                                           kv_quant="int8", prefill_chunk=64),
                       vit=cfg.vit.replace(dtype="float32"),
                       beats=cfg.beats.replace(dtype="float32"),
                       qformer=cfg.qformer.replace(dtype="float32"))


@pytest.fixture(scope="module")
def assembly():
    """Both packages' tiny assemblies (f32, int8 weights and KV) with the
    same weights, and each one's upfront-encoded requests."""
    jcfg, jdata = _f32_int8(j_tiny()), j_tiny_data(n_frms=4)
    jm = JModel(jcfg, audio_cfg=jdata.audio)
    params = _random_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                          np.random.default_rng(1))
    tcfg, tdata = _f32_int8(tiny_model_config()), tiny_data_config(n_frms=4)
    tm = XInstructBLIP(tcfg, audio_cfg=tdata.audio, device="cpu")
    cast_params_for_inference(load_jax_params_(tm, params))
    anns = _annotations()
    jreqs = j_encode_requests(jm, params, JDataset(jdata, annotations=anns), encode_batch=2,
                              host_ahead=0)
    treqs = cli_serve.encode_requests(tm, MRDataset(tdata, annotations=anns), encode_batch=2,
                                      host_ahead=0)
    return (jm, params, jreqs), (tm, treqs)


@pytest.fixture(scope="module")
def port_assembly():
    """The port's tiny assembly alone (seeded random weights), its
    dataset and its upfront-encoded requests."""
    from mraudio_tpu_torch.config import RunConfig
    from mraudio_tpu_torch.infer.evaluate import build_model

    cfg = RunConfig(model=_f32_int8(tiny_model_config()), data=tiny_data_config(n_frms=4))
    tm = cast_params_for_inference(build_model(cfg, "cpu"))
    ds = MRDataset(cfg.data, annotations=_annotations())
    return tm, cli_serve.encode_requests(tm, ds, encode_batch=2, host_ahead=0), ds


def _strip(records):
    return sorted(({k: v for k, v in r.items() if k != "latency_s"} for r in records),
                  key=lambda r: r["qid"])


def test_serve_matches_jax(assembly):
    """Per request, the annotation, the host twin of the interleave mask
    and the hint stream exactly as JAX's (the prefixes themselves are held
    through the records); then ``serve()``'s records equal JAX's without
    the latency, in burst and in Poisson load mode, and the stats carry
    the JAX CLI's keys."""
    (jm, params, jreqs), (tm, treqs) = assembly
    assert len(treqs) == len(jreqs) == 4
    for (jr, jann), (tr, tann) in zip(jreqs, treqs):
        assert jann == tann and jr.request_id == tr.request_id
        np.testing.assert_array_equal(tr.prefix_mask, np.asarray(jr.prefix_mask))
        np.testing.assert_array_equal(tr.hint_ids, np.asarray(jr.hint_ids))
        assert tuple(tr.prefix_embeds.shape) == np.asarray(jr.prefix_embeds).shape
    for arrivals in (None, cli_serve.poisson_arrivals(len(treqs), 20.0, 1)):
        kw = dict(max_prefill_batch=2, arrivals=arrivals)
        ref, jstats = j_serve(jm, params, jreqs, 2, jm.cfg.max_new_tokens, **kw)
        got, stats = cli_serve.serve(tm, treqs, 2, tm.cfg.max_new_tokens, **kw)
        assert _strip(got) == _strip(ref) and len(got) == 4
        assert sorted(stats) == sorted(jstats)
        assert all(r["latency_s"] > 0 for r in got)
    assert stats["load"]["latency_from"] == "arrival" and stats["load"]["offered_rps"] > 0


def test_serve_inline_stream_and_engine_cache(port_assembly):
    """Inline encoding (with host prefetch and upload ahead) and a kept
    engine give the upfront records."""
    tm, treqs, ds = port_assembly
    base, _ = cli_serve.serve(tm, treqs, 2, tm.cfg.max_new_tokens)
    holder = {}
    for _ in range(2):
        stream = cli_serve.encode_request_stream(tm, ds, encode_batch=2, host_ahead=2,
                                                 upload_ahead=True)
        got, stats = cli_serve.serve(tm, None, 2, tm.cfg.max_new_tokens, request_stream=stream,
                                     encode_batch=2, engine_cache=holder)
        assert _strip(got) == _strip(base)
        assert stats["encode_mode"] == "inline" and stats["encode_ahead"] == 2
    assert holder["engine"].cache is not None


def test_serve_empty_stream(port_assembly):
    tm, _, ds = port_assembly
    records, stats = cli_serve.serve(tm, [], 2, 4)
    assert records == [] and stats["requests"] == 0 and stats["encode_mode"] == "upfront"
    empty = cli_serve.encode_request_stream(tm, ds, limit=0, host_ahead=0)
    records, stats = cli_serve.serve(tm, None, 2, 4, request_stream=empty)
    assert records == [] and stats["encode_mode"] == "inline"


def test_encode_stream_oom_backpressure():
    """A group whose device stage runs out of device memory is retried
    once after the installed recovery; without one, or for other errors,
    the exception propagates."""
    calls = {"drained": 0}

    def fail_once():
        failed = set()

        def device_stage(tag):
            if tag == "boom" and tag not in failed:
                failed.add(tag)
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return [(tag, 0), (tag, 1)]

        return device_stage

    stream = cli_serve._EncodeStream(iter([("ok",), ("boom",)]), fail_once(), None, 0)
    assert [next(stream), next(stream)] == [("ok", 0), ("ok", 1)]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        next(stream)

    def drain():
        calls["drained"] += 1

    stream = cli_serve._EncodeStream(iter([("boom",), ("ok",)]), fail_once(), None, 0)
    stream.oom_recover = drain
    assert list(stream) == [("boom", 0), ("boom", 1), ("ok", 0), ("ok", 1)]
    assert calls["drained"] == 1

    def bad_stage(tag):
        raise ValueError("unrelated")

    stream = cli_serve._EncodeStream(iter([("x",)]), bad_stage, None, 0)
    stream.oom_recover = drain
    with pytest.raises(ValueError, match="unrelated"):
        next(stream)


def test_prefetched_stream_propagates_errors():
    def boom():
        yield 1
        raise RuntimeError("encode failed")

    stream = cli_serve._PrefetchedStream(boom(), ahead=2)
    assert next(stream) == 1
    with pytest.raises(RuntimeError, match="encode failed"):
        next(stream)


# --------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def ann_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "ann.jsonl"
    path.write_text("".join(json.dumps(a) + "\n" for a in _annotations(5)))
    return path


def _cli(ann_file, out, *extra):
    stats = cli_serve.main(["--annotation-file", str(ann_file), "--video-source", "synthetic",
                            "--model-size", "tiny", "--n-frms", "4", "--slots", "2",
                            "--device", "cpu", "--output-file", str(out), *extra])
    return stats, [json.loads(line) for line in out.read_text().splitlines()]


def test_cli_end_to_end_and_flags(ann_file, tmp_path):
    """The CLI writes one record per annotation with the stats line's
    keys; ``--embeds``, ``--encode-batch``, ``--encode-ahead``, inline
    encoding, load mode and the slice of depth/steps settings leave the
    records as they are."""
    stats, base = _cli(ann_file, tmp_path / "base.jsonl")
    assert sorted(r["qid"] for r in base) == list(range(5))
    assert all("pred_relevant_windows" in r and r["latency_s"] > 0 for r in base)
    for key in ("requests_per_sec", "latency_p50_s", "latency_p95_s", "prefill_s", "decode_s",
                "decode_steps", "sec_per_decode_step", "encode_s"):
        assert key in stats
    for i, extra in enumerate((["--embeds", "device", "--encode-batch", "3"],
                               ["--encode-mode", "inline", "--encode-batch", "3",
                                "--encode-ahead", "2"],
                               ["--encode-mode", "inline", "--encode-ahead", "0"],
                               ["--arrival-rate", "30", "--steps-per-dispatch", "2"],
                               ["--spec-width", "4", "--kv-keep", "100000"])):
        s2, rows = _cli(ann_file, tmp_path / f"run{i}.jsonl", *extra)
        assert _strip(rows) == _strip(base), extra
        assert s2["requests"] == 5
    # the last run compacted (keeping the whole prefix) and speculated
    assert s2["kv_keep"] > 0 and s2["spec_width"] == 4


def test_cli_request_timeout(ann_file, tmp_path):
    """An unmeetable deadline: every request completes or is reported."""
    stats, rows = _cli(ann_file, tmp_path / "t.jsonl", "--arrival-rate", "50",
                       "--request-timeout", "0.001")
    assert stats["timeouts"] + stats["requests"] == 5 and stats["timeouts"] >= 1
    assert len(rows) == stats["requests"]
    assert {r["qid"] for r in rows} | {t["qid"] for t in stats["timed_out"]} == set(range(5))


@pytest.mark.parametrize("flag", [["--model-path", "x"], ["--audio-encoder", "x"],
                                  ["--params-store", "x"], ["--checkpoint", "x"],
                                  ["--quant-encoders"], ["--model", "VideoLLaMA"]])
def test_cli_unported_flags_raise(ann_file, tmp_path, flag):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.\d"):
        _cli(ann_file, tmp_path / "x.jsonl", *flag)


@pytest.mark.parametrize("what, item", [("mesh", "A.7"), ("llm_weights", "A.8")])
def test_cli_config_asking_unported_raises(ann_file, tmp_path, what, item):
    """A JAX package YAML with a tensor-parallel mesh (the reference's
    serving on a TP mesh) or with converted weights is refused."""
    from mraudio_tpu.config import MeshConfig as JMeshConfig
    from mraudio_tpu.config import RunConfig as JRunConfig

    extra = ({"mesh": JMeshConfig(data=1, model=2)} if what == "mesh"
             else {what: str(tmp_path / "weights")})
    config = tmp_path / "run.yaml"
    JRunConfig(model=j_tiny(), data=j_tiny_data(n_frms=4), **extra).to_yaml(str(config))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        _cli(ann_file, tmp_path / "x.jsonl", "--config", str(config))


def test_cli_without_device_cpu_needs_a_card(ann_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        cli_serve.main(["--annotation-file", str(ann_file), "--video-source", "synthetic",
                        "--model-size", "tiny"])
