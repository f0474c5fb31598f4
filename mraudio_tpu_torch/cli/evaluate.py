"""Inference CLI: annotations → QVH submission JSONL.

    python -m mraudio_tpu_torch.cli.evaluate --annotation-file A.jsonl \\
        --output-file P.jsonl [--model-size full|tiny] [--device cuda|cpu]

The JAX package's flag surface (``mraudio_tpu/cli/evaluate.py``) plus
``--device`` (default ``cuda``; asking for it without a card raises).
``--model-size full`` runs ``full_model_config()`` with its defaults
(int8 Vicuna-7B, int8 KV cache, ``prefill_chunk=2048``, chunked
attention, ``decode_gemv="xla"``) and ``DataConfig.for_dataset``;
``tiny`` the tiny presets; ``--config`` a YAML RunConfig.  Weights are
random from ``train.seed``, with the reference checkpoints the config,
``--model-path`` (the HF Vicuna state dict) and ``--audio-encoder`` (the
BEATs checkpoint) name converted over them; ``--params-store`` loads a
store of ``cli/convert.py`` instead; ``--checkpoint`` overlays the
trained leaves of a checkpoint of ``cli/finetune.py``.  ``--model
VideoLLaMA`` runs the second backbone (``models/videollama.py``) from the
same size knobs; its ``--model-path`` is the merged VideoLLaMA2-AV
checkpoint.  ``--fast`` applies
``apply_fast_preset`` (temporal-residual ViT, yuv420 wire, grammar-
constrained decoding with ``spec_width=4``).  ``--quant-encoders`` stores
the frozen encoders' large kernels int8 (``models/quant_tree.py``); the
int4 weights and cache, W8A8, ``scan_layers`` and ``mlp_seq_chunk`` come
from a ``--config``'s ``model.llm`` (``quantization: int4``, ``kv_quant:
int4``, ``int8_dot``, ...).  A ``--config`` that names a tokenizer
raises ``NotImplementedError`` naming the ROADMAP.md item.

A ``--config`` with a mesh (``mesh: {data: D, model: M}``) runs under a
distributed launch of D x M processes, one per card (or per CPU process
with ``--device cpu``, over gloo):

    python -m torch.distributed.run --nproc-per-node 4 \
        -m mraudio_tpu_torch.cli.evaluate --config mesh.yaml ...

``--batch-size`` is the global batch (D must divide it); rank 0 writes
the output.  ``--seq-shard`` splits the prefill's residual stream along
S over the model ranks (``LlamaConfig.seq_shard``).
"""

from __future__ import annotations

import argparse
import logging


def build_config(args):
    from mraudio_tpu_torch.config import (
        DataConfig,
        RunConfig,
        full_model_config,
        tiny_data_config,
        tiny_model_config,
    )

    if args.config:
        cfg = RunConfig.from_yaml(args.config)
    elif args.model_size == "tiny":
        cfg = RunConfig(
            model=tiny_model_config(), data=tiny_data_config(n_frms=args.n_frms or 4)
        )
    else:
        cfg = RunConfig(
            model=full_model_config(), data=DataConfig.for_dataset(args.dataset)
        )

    data = cfg.data.replace(
        video_folder=args.video_folder or cfg.data.video_folder,
        annotation_file=args.annotation_file or cfg.data.annotation_file,
        num_chunks=args.num_chunks,
        chunk_idx=args.chunk_idx,
    )
    if args.video_source:
        data = data.replace(video_source=args.video_source)
    return cfg.replace(
        model_name=args.model,
        data=data,
        llm_weights=args.model_path or cfg.llm_weights,
        beats_weights=args.audio_encoder or cfg.beats_weights,
    )


def load_trained(model, path: str):
    """Overlay the trained leaves of the checkpoint ``path`` (the port's
    format, ``train/checkpoint.py``) onto ``model``."""
    from mraudio_tpu_torch.train.checkpoint import apply_trainable, load_checkpoint

    payload = load_checkpoint(path)
    apply_trainable(model, payload["model"])
    logging.getLogger("mraudio_tpu_torch").info(
        "loaded trained checkpoint %s (epoch %s, %d trained leaves)",
        path, payload.get("epoch"), len(payload["model"]))
    return model


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="mraudio_tpu_torch batched inference")
    parser.add_argument("--model", default="X-InstructBLIP")
    parser.add_argument("--model-path", default="",
                        help="LLM weights: an HF Llama state dict (for VideoLLaMA, the merged "
                             "AV checkpoint), converted at load")
    parser.add_argument("--checkpoint", default="", help="trained checkpoint dir to overlay")
    parser.add_argument("--audio-encoder", default="",
                        help="BEATs checkpoint, converted at load")
    parser.add_argument("--video-folder", default="")
    parser.add_argument("--annotation-file", required=True)
    parser.add_argument("--output-file", required=True)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--dataset", default="QVH")
    parser.add_argument("--config", default="", help="YAML RunConfig path")
    parser.add_argument("--video-source", default="", choices=["", "native", "synthetic", "npy"])
    parser.add_argument("--model-size", default="full", choices=["full", "tiny"])
    parser.add_argument("--n-frms", type=int, default=0)
    parser.add_argument("--profile-dir", default="",
                        help="write a torch.profiler chrome trace of the run here")
    parser.add_argument("--no-batch-fallback", action="store_true",
                        help="fail instead of halving the batch on device OOM")
    parser.add_argument("--params-store", default="",
                        help="param store from mraudio_tpu_torch.cli.convert (skips the "
                             "init and the conversion at launch)")
    parser.add_argument("--quant-encoders", action="store_true",
                        help="store the frozen encoders' large kernels int8, dequantized "
                             "where read (an approximation: the reference keeps them fp16)")
    parser.add_argument("--seq-shard", action="store_true",
                        help="sequence parallelism on a model axis > 1 (LlamaConfig.seq_shard; "
                             "predictions identical)")
    parser.add_argument("--fast", action="store_true",
                        help="the stacked-throughput preset: temporal-residual ViT (an "
                             "approximation), yuv420 wire, grammar-constrained decoding")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = build_config(args)
    if args.quant_encoders:
        cfg = cfg.replace(quant_encoders=True)
    if args.seq_shard:
        cfg = cfg.replace(model=cfg.model.replace(llm=cfg.model.llm.replace(seq_shard=True)))
    if args.fast:
        from mraudio_tpu_torch.config import apply_fast_preset

        cfg = apply_fast_preset(cfg)

    from mraudio_tpu_torch.cli.convert import resolve_params
    from mraudio_tpu_torch.infer.evaluate import refuse_unported, run_inference
    from mraudio_tpu_torch.models.factory import build_model

    from mraudio_tpu_torch.device import is_main_process, launched_distributed, process_group

    refuse_unported(cfg)
    needed = cfg.mesh.num_devices > 1 or launched_distributed()
    with process_group(args.device, needed=needed) as device:
        if not is_main_process():
            logging.getLogger().setLevel(logging.WARNING)
        # --model dispatch, as the reference's evaluate.py:27-31
        model = resolve_params(build_model(cfg, device), cfg, args.params_store)
        if args.checkpoint:
            load_trained(model, args.checkpoint)
        result = run_inference(
            cfg, model=model, output_file=args.output_file, batch_size=args.batch_size,
            num_workers=args.num_workers, profile_dir=args.profile_dir or None,
            batch_fallback=not args.no_batch_fallback, device=device,
        )
        if is_main_process():
            print(f"wrote {len(result['records'])} predictions to {args.output_file} "
                  f"({result['clips_per_sec']:.3f} clips/sec)")
    return result


if __name__ == "__main__":
    main()
