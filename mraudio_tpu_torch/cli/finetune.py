"""Training CLI: LoRA fine-tuning (the JAX package's ``cli/finetune.py``).

    python -m mraudio_tpu_torch.cli.finetune --train-annotation-file T.jsonl \\
        --val-annotation-file V.jsonl --output-dir OUT \\
        [--model-size full|tiny] [--device cuda|cpu]

The JAX package's flags plus ``--device`` (default ``cuda``; asking for
it without a card raises).  ``--model-size full`` trains
``full_model_config()`` (int8 Vicuna-7B base, LoRA r = 8 on all seven
projections) with ``vit.grad_checkpoint`` and ``llm.grad_checkpoint``
on and the ``TrainConfig`` defaults (AdamW, lr 3e-4, warmup over 1000
steps, 2 accumulation steps, augmentation, nan guard, preempt save, the
encoders run apart from the loss step); ``tiny`` the tiny presets;
``--config`` a YAML or JSON RunConfig.  Weights are random from
``train.seed`` with the checkpoints the config, ``--model-path`` and
``--audio-encoder`` name converted over them, or a ``--params-store`` of
``cli/convert.py``.  It writes ``checkpoint_best``, ``checkpoint_<epoch>``
(each with a ``.meta.json`` sidecar) and ``train.jsonl`` to the output
directory; ``--resume`` continues from a checkpoint (mid-epoch from
``checkpoint_preempt``).  ``--model VideoLLaMA`` trains the second
backbone's LoRA adapters, connector and audio projector.
``--quant-frozen int8`` stores the frozen kernels int8; ``--single-chip``
applies the JAX package's single-chip memory stack as it sets it
(``mraudio_tpu/cli/finetune.py:141-160``): ViT and block remat,
``scan_layers``, ``attention_unroll_train`` (accepted, no effect here),
``quant_frozen="int8"``, the split encode step and
``encoder_window=max(train.encoder_window, 12)``.

``--distributed`` (or a ``--config`` whose mesh has more than one
device) joins the process group of a distributed launch, one process per
card (NCCL), or per CPU process with ``--device cpu`` (gloo):

    python -m torch.distributed.run --nproc-per-node 4 \
        -m mraudio_tpu_torch.cli.finetune --config mesh.yaml ...

The config's mesh (``mesh: {data: D, model: M}``) must have as many
devices as the launch has processes; without one, every process is a
data rank.  ``--batch-size`` is the global batch.  ``--seq-shard``
splits the residual stream along S over the model ranks.
"""

from __future__ import annotations

import argparse
import logging


def build_config(args):
    from mraudio_tpu_torch.config import (DataConfig, RunConfig, full_model_config,
                                          tiny_data_config, tiny_model_config)

    if args.config:
        cfg = RunConfig.from_yaml(args.config)
    elif args.model_size == "tiny":
        cfg = RunConfig(model=tiny_model_config(), data=tiny_data_config())
    else:
        # int8 frozen base + LoRA adapters, with rematerialization: the
        # backward of the full model keeps one block input per layer
        model = full_model_config()
        cfg = RunConfig(
            model=model.replace(vit=model.vit.replace(grad_checkpoint=True),
                                llm=model.llm.replace(grad_checkpoint=True)),
            data=DataConfig.for_dataset(args.dataset),
        )
    return cfg.replace(
        model_name=args.model,
        data=cfg.data.replace(
            video_folder=args.video_folder or cfg.data.video_folder,
            train_annotation_file=args.train_annotation_file,
            val_annotation_file=args.val_annotation_file,
            **({"video_source": args.video_source} if args.video_source else {}),
        ),
        train=cfg.train.replace(
            output_dir=args.output_dir, val_freq=args.val_freq, save_freq=args.save_freq,
            max_epoch=args.max_epoch, batch_size=args.batch_size,
            num_workers=args.num_workers, resume_ckpt_path=args.resume,
            **({"quant_frozen": args.quant_frozen} if args.quant_frozen else {}),
        ),
        llm_weights=args.model_path or cfg.llm_weights,
        beats_weights=args.audio_encoder or cfg.beats_weights,
    )


def apply_single_chip(cfg):
    """``--single-chip``: the JAX package's single-chip memory stack, field
    for field.  ``attention_unroll_train`` unrolls XLA's tile loop there
    and changes nothing here (the port's tile loop is a Python loop)."""
    return cfg.replace(
        model=cfg.model.replace(
            vit=cfg.model.vit.replace(grad_checkpoint=True),
            llm=cfg.model.llm.replace(grad_checkpoint=True, scan_layers=True,
                                      attention_unroll_train=True)),
        train=cfg.train.replace(quant_frozen="int8", split_encode_step=True,
                                encoder_window=max(cfg.train.encoder_window, 12)),
    )


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="mraudio_tpu_torch finetuning")
    parser.add_argument("--model", default="X-InstructBLIP")
    parser.add_argument("--model-path", default="",
                        help="LLM weights: an HF Llama state dict (for VideoLLaMA, the merged "
                             "AV checkpoint), converted at load")
    parser.add_argument("--audio-encoder", default="",
                        help="BEATs checkpoint, converted at load")
    parser.add_argument("--video-folder", default="")
    parser.add_argument("--train-annotation-file", required=True)
    parser.add_argument("--val-annotation-file", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--val-freq", type=int, default=1)
    parser.add_argument("--save-freq", type=int, default=1)
    parser.add_argument("--max-epoch", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--dataset", default="QVH")
    parser.add_argument("--config", default="", help="YAML or JSON RunConfig path")
    parser.add_argument("--video-source", default="", choices=["", "native", "synthetic", "npy"])
    parser.add_argument("--model-size", default="full", choices=["full", "tiny"])
    parser.add_argument("--resume", default="", help="checkpoint to resume from")
    parser.add_argument("--quant-frozen", default="", choices=["", "none", "int8"],
                        help="store the frozen kernels int8, dequantized where read "
                             "(models/quant_tree.py)")
    parser.add_argument("--optimizer", default="adamw", choices=["adamw", "adam"],
                        help="'adamw' = the reference's intended optimizer; 'adam' its live "
                             "plain-Adam override")
    parser.add_argument("--params-store", default="",
                        help="param store from mraudio_tpu_torch.cli.convert")
    parser.add_argument("--single-chip", action="store_true",
                        help="the JAX package's single-chip memory stack: remat, scan_layers, "
                             "quant_frozen int8, the split encode step and an encoder window of "
                             "at least 12 batches (its attention_unroll_train is accepted and "
                             "has no effect here)")
    parser.add_argument("--seq-shard", action="store_true",
                        help="sequence parallelism on a model axis > 1 (LlamaConfig.seq_shard)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group of a torch.distributed.run launch (one "
                             "process per device); without a mesh in the config every process "
                             "is a data rank")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = build_config(args)
    if args.seq_shard:
        cfg = cfg.replace(model=cfg.model.replace(llm=cfg.model.llm.replace(seq_shard=True)))
    if args.single_chip:
        cfg = apply_single_chip(cfg)

    from mraudio_tpu_torch.cli.convert import resolve_params
    from mraudio_tpu_torch.config import MeshConfig
    from mraudio_tpu_torch.device import is_main_process, launched_distributed, process_group
    from mraudio_tpu_torch.models.factory import build_model
    from mraudio_tpu_torch.train.trainer import Trainer, refuse_unported

    refuse_unported(cfg)
    needed = args.distributed or cfg.mesh.num_devices > 1 or launched_distributed()
    with process_group(args.device, needed=needed) as device:
        if args.distributed and cfg.mesh.num_devices == 1:
            import torch.distributed as dist

            cfg = cfg.replace(mesh=MeshConfig(data=dist.get_world_size(), model=1))
        if not is_main_process():
            logging.getLogger().setLevel(logging.WARNING)
        # --model dispatch, as the reference's utils/trainer.py:50-56
        model = resolve_params(build_model(cfg, device), cfg, args.params_store)
        trainer = Trainer(cfg, model=model, optimizer=args.optimizer, device=device)
        summary = trainer.train()
        if is_main_process():
            print(f"best epoch {summary['best_epoch']}: MR-full-R1-avg "
                  f"{summary['best_metric']}")
    return summary


if __name__ == "__main__":
    main()
