"""Convert reference-format checkpoints into the port's param store (the
JAX package's ``cli/convert.py``).

The reference re-loads and re-routes its torch checkpoints at every
launch (reference ``models/xinstructblip.py:614-655,706-735`` and the HF
Vicuna load at ``:147-163``).  This CLI runs the same conversion once
(``models/convert_weights.py::load_pretrained_params``: seeded init, the
key routing and the int8 quantization the model config asks for) and
writes the finished parameters, before the inference cast, to a store;
``--params-store S`` on the evaluate and serve CLIs then loads it.

The store is one ``torch.save`` file of a flat dict keyed by the JAX
param store's flat names (``'/'``-joined flax paths), each tensor in the
flax layout, with the JAX store's ``<path>.meta.json`` sidecar (the JAX
store itself is orbax, which needs JAX).  It is read with
``torch.load(weights_only=True, mmap=True)``.

    python -m mraudio_tpu_torch.cli.convert --model-size full \\
        --model-path /ckpts/vicuna_hf_state_dict.pth \\
        --audio-encoder /ckpts/BEATs_iter3_plus_AS2M.pt \\
        --vit /ckpts/eva_vit_g.pth \\
        --video-qformer /ckpts/video_qformer.pth \\
        --audio-qformer /ckpts/audio_qformer_improved.pth \\
        --blip2 /ckpts/blip2_pretrained.pth \\
        --output /stores/xinstructblip_full.pt [--device cuda|cpu]

    python -m mraudio_tpu_torch.cli.convert --model VideoLLaMA \\
        --model-path /ckpts/videollama2_av.pth [--audio-encoder BEATs.pt] \\
        --output /stores/videollama_full.pt

For ``--model VideoLLaMA`` the ``--model-path`` checkpoint is the merged
VideoLLaMA2-AV state dict (vision tower, projectors, BEATs and the LLM,
``convert_weights.convert_videollama``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch


def _meta_path(path: str) -> str:
    return os.path.abspath(path) + ".meta.json"


def store_meta(cfg) -> dict:
    """The config fields a store must agree with (the JAX store's)."""
    return {"model_name": cfg.model_name, "quantization": cfg.model.llm.quantization,
            "scan_layers": bool(cfg.model.llm.scan_layers)}


def save_param_store(path: str, model, meta: dict | None = None) -> str:
    """Write ``model``'s parameters to the store file ``path`` under their
    flat flax names, in the flax layout, on the host; ``meta`` goes to
    the ``<path>.meta.json`` sidecar."""
    from mraudio_tpu_torch.models.convert_jax import flax_params

    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: t.cpu().contiguous() for k, t in flax_params(model).items()}, path)
    with open(_meta_path(path), "w") as f:
        json.dump(dict(meta or {}), f)
    return path


def load_param_store(path: str) -> dict:
    """The tree a store holds, as nested dicts of host tensors (memory-
    mapped from the file)."""
    from mraudio_tpu_torch.models.convert_jax import nested

    return nested(torch.load(os.path.abspath(path), map_location="cpu", weights_only=True,
                             mmap=True))


def load_store_meta(path: str) -> dict:
    try:
        with open(_meta_path(path)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def resolve_params(model, cfg, params_store: str = ""):
    """The CLIs' parameter source, loaded into ``model``: a store when
    given (its meta checked against the live config; every parameter must
    be in it), else the checkpoints ``cfg`` names over the seeded init.
    Returns ``model``, uncast."""
    if params_store:
        meta = load_store_meta(params_store)
        for k, v in store_meta(cfg).items():
            if k in meta and meta[k] != v:
                raise ValueError(
                    f"param store {params_store} was converted with "
                    f"{k}={meta[k]!r} but this run's config wants {v!r} — "
                    "re-run mraudio_tpu_torch.cli.convert with the matching config")
        from mraudio_tpu_torch.models.convert_jax import load_jax_params_

        return load_jax_params_(model, load_param_store(params_store))
    from mraudio_tpu_torch.models.convert_weights import load_pretrained_params

    return load_pretrained_params(model, cfg)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="convert reference checkpoints to a mraudio_tpu_torch param store")
    parser.add_argument("--model", default="X-InstructBLIP")
    parser.add_argument("--model-size", default="full", choices=["full", "tiny"])
    parser.add_argument("--config", default="", help="YAML RunConfig path")
    parser.add_argument("--output", required=True, help="param store file to write")
    parser.add_argument("--model-path", default="",
                        help="LLM weights (HF Llama state dict; for VideoLLaMA, the merged AV "
                             "checkpoint)")
    parser.add_argument("--audio-encoder", default="", help="BEATs .pt")
    parser.add_argument("--vit", default="", help="EVA-ViT-g .pth")
    parser.add_argument("--video-qformer", default="", help="video Q-Former bundle .pth")
    parser.add_argument("--audio-qformer", default="", help="audio Q-Former bundle .pth")
    parser.add_argument("--blip2", default="", help="BLIP-2 stage-1 .pth")
    parser.add_argument("--device", default="cuda",
                        help="torch device the model is built on (default cuda)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from mraudio_tpu_torch.config import (DataConfig, RunConfig, full_model_config,
                                          tiny_data_config, tiny_model_config)
    from mraudio_tpu_torch.models.convert_weights import load_pretrained_params
    from mraudio_tpu_torch.models.factory import build_model

    if args.config:
        cfg = RunConfig.from_yaml(args.config)
    elif args.model_size == "tiny":
        cfg = RunConfig(model=tiny_model_config(), data=tiny_data_config())
    else:
        cfg = RunConfig(model=full_model_config(), data=DataConfig.for_dataset("QVH"))
    cfg = cfg.replace(
        model_name=args.model,
        llm_weights=args.model_path or cfg.llm_weights,
        vit_weights=args.vit or cfg.vit_weights,
        beats_weights=args.audio_encoder or cfg.beats_weights,
        video_qformer_weights=args.video_qformer or cfg.video_qformer_weights,
        audio_qformer_weights=args.audio_qformer or cfg.audio_qformer_weights,
        blip2_stage1_weights=args.blip2 or cfg.blip2_stage1_weights,
    )

    model = load_pretrained_params(build_model(cfg, args.device), cfg)
    path = save_param_store(args.output, model, store_meta(cfg))
    n = sum(p.numel() for p in model.parameters())
    print(f"wrote param store ({n} params) to {path}")
    return path


if __name__ == "__main__":
    main()
