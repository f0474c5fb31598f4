"""Training runtime: the LoRA train step, the epoch loop, validation and
checkpoints (the JAX package's ``train/trainer.py``).

* A micro-step: the text is prepared on the host (``loss_arrays``); with
  ``split_encode_step`` the frozen encoders run under ``torch.no_grad``
  (span ``encode``), then the loss forward and backward into the
  trainable leaves (span ``loss_fwd_bwd``), then the optimizer
  (``train/optim.py``, span ``optimizer``).  bf16 compute needs no
  gradient scaler.
* ``train.nan_guard``: a non-finite loss zeroes that micro-batch's
  gradients and suppresses the update it feeds, on the device; the loss
  is read on the host one micro-step later, so the step loop does not
  wait on the device, and training aborts after ``max_nan_skips``
  consecutive non-finite losses.
* Crops are keyed on ``(seed + 17, step)`` and LoRA dropout on
  ``(seed + 29, step)``, so a resumed run continues both streams without
  replaying the skipped steps; a SIGTERM saves ``checkpoint_preempt`` with
  the exact step position and a resume from it continues mid-epoch.
* Validation generates on the val split and scores the records against
  themselves (each carries the ground truth and the prediction); the best
  MR-full-R1-avg selects ``checkpoint_best``.

Refused (``NotImplementedError`` naming the ROADMAP.md item):
``quant_frozen="int8"`` (A.2), ``encoder_window`` and ``upload_overlap``
(A.11), a mesh of more than one device (A.7).

Both backbones train: X-InstructBLIP (LoRA, and the saliency head) and
VideoLLaMA (LoRA, the connector and the audio projector), each by its
``TRAINABLE_PATTERN``.  The encoders run apart only for a model that names
its ``ENCODER_PARAM_KEYS`` and has ``_loss_from_tokens``.
"""

from __future__ import annotations

import json
import logging
import os
import signal

import numpy as np
import torch
from torch.profiler import record_function

from mraudio_tpu_torch.config import RunConfig
from mraudio_tpu_torch.data.dataset import BatchLoader, MRDataset
from mraudio_tpu_torch.eval.mr_eval import eval_submission
from mraudio_tpu_torch.models.casting import keeps_dtype
from mraudio_tpu_torch.models.convert_jax import flax_params, torch_name
from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process
from mraudio_tpu_torch.train import checkpoint as ckpt
from mraudio_tpu_torch.train.optim import (DEFAULT_TRAINABLE_PATTERN, build_optimizer,
                                           lavis_warmup_cosine_schedule, split_trainable)
from mraudio_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from mraudio_tpu_torch.utils.runlog import RunLogger

logger = logging.getLogger("mraudio_tpu_torch")


class Preempted(RuntimeError):
    """Raised after a SIGTERM-triggered save: the trainable leaves, the
    optimizer state and the exact step position are on disk as
    ``checkpoint_preempt``."""


def refuse_unported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP.md item, for a
    training configuration the port does not run."""
    tc = cfg.train
    if tc.quant_frozen == "int8":
        raise NotImplementedError("train.quant_frozen='int8' is not ported yet "
                                  "(ROADMAP.md A.2: models/quant_tree.py)")
    if tc.quant_frozen not in ("none", ""):
        raise ValueError(f"unknown quant_frozen={tc.quant_frozen!r}")
    if tc.encoder_window > 0 or tc.upload_overlap:
        raise NotImplementedError("train.encoder_window and train.upload_overlap are not "
                                  "ported yet (ROADMAP.md A.11: utils/packing.py)")
    if cfg.mesh.num_devices > 1:
        raise NotImplementedError("a mesh of more than one device is not ported yet "
                                  "(ROADMAP.md A.7: parallelism)")


class Trainer:
    def __init__(self, cfg: RunConfig, model=None, train_dataset: MRDataset | None = None,
                 val_dataset: MRDataset | None = None, optimizer: str = "adamw",
                 frozen_bf16: bool = True, device="cuda"):
        """``model``: a backbone module with its weights (default:
        seeded random weights and the checkpoints ``cfg`` names, on
        ``device``).  Its trainable leaves become f32 masters that need a
        gradient; with ``frozen_bf16`` every other float leaf is cast by
        the inference rule (int8 weights, norms and scales keep theirs)."""
        refuse_unported(cfg)
        self.cfg = cfg
        tc = cfg.train
        if model is None:
            from mraudio_tpu_torch.infer.evaluate import build_model

            model = build_model(cfg, device)
        self.model = model
        self.trainable_pattern = getattr(model, "TRAINABLE_PATTERN", DEFAULT_TRAINABLE_PATTERN)
        params = dict(model.named_parameters())
        names, _ = split_trainable(flax_params(model), self.trainable_pattern)
        self.trainable = {}
        with torch.no_grad():
            for flax_name, view in names.items():
                p = params[torch_name(tuple(flax_name.split("/")))]
                if p.shape != view.shape:
                    raise ValueError(f"trainable leaf {flax_name} is stored reshaped")
                p.data = p.data.float()
                p.requires_grad_(True)
                self.trainable[flax_name] = p
            trained = {id(p) for p in self.trainable.values()}
            for name, p in params.items():
                if id(p) in trained:
                    continue
                p.requires_grad_(False)
                if frozen_bf16 and not keeps_dtype(name, p):
                    p.data = p.data.to(torch.bfloat16)
        n_train = sum(p.numel() for p in self.trainable.values())
        logger.info("trainable params: %d / %d", n_train,
                    sum(p.numel() for p in params.values()))
        enc_keys = getattr(model, "ENCODER_PARAM_KEYS", None)
        self.split_encode = (tc.split_encode_step and enc_keys is not None
                             and hasattr(model, "_loss_from_tokens")
                             and not any(k.split("/")[0] in enc_keys for k in self.trainable))

        if train_dataset is None:
            train_dataset = MRDataset(cfg.data, annotation_path=cfg.data.train_annotation_file,
                                      split="train")
        if val_dataset is None:
            val_dataset = MRDataset(cfg.data, annotation_path=cfg.data.val_annotation_file,
                                    split="eval")
        durations = [a["duration"] for ds in (train_dataset, val_dataset) for a in ds.annotation]
        if hasattr(model, "prepare_text") and durations:
            from mraudio_tpu_torch.text.tokenizer import validate_time_budgets

            validate_time_budgets(model.llm_tokenizer, model.cfg, int(max(durations)) + 1)
        self.train_loader = BatchLoader(train_dataset, tc.batch_size, shuffle=True, seed=tc.seed,
                                        drop_last=True, num_threads=max(tc.num_workers, 1))
        self.val_loader = BatchLoader(val_dataset, tc.batch_size, shuffle=False,
                                      num_threads=max(tc.num_workers, 1))

        self.steps_per_epoch = max(len(self.train_loader), 1)
        self.opt = build_optimizer(tc, self.trainable, self.steps_per_epoch, optimizer)
        self.schedule = lavis_warmup_cosine_schedule(tc, self.steps_per_epoch)
        self.start_epoch = 0
        self.global_step = 0
        self._nan_skips = 0          # consecutive non-finite losses
        self._pending = None         # (loss on the device, step, epoch), read one step late
        self._skip_steps = 0
        self._step_in_epoch = 0
        self._preempt_requested = False
        self._preempt_path = None
        self._prev_sigterm = None
        self._sigterm_installed = False
        if tc.preempt_save:
            def _on_sigterm(signum, frame):
                self._preempt_requested = True

            try:
                self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
                self._sigterm_installed = True
            except ValueError:
                pass  # not the main thread

        os.makedirs(tc.output_dir, exist_ok=True)
        self.runlog = RunLogger(tc.output_dir, "train")
        if tc.resume_ckpt_path:
            self._load_checkpoint(tc.resume_ckpt_path)

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------------

    def _sample_crops(self, batch, step: int | None = None):
        """Per-clip crop-and-flip parameters (B, 5) on the device for the
        micro-step ``step`` (default: the next), sampled on the RGB frame
        size; None with ``train.augment`` off."""
        if not self.cfg.train.augment:
            return None
        from mraudio_tpu_torch.ops.image import sample_crop_params

        step = self.global_step if step is None else step
        v = np.asarray(batch.video)
        h, w = (v.shape[2] * 2 // 3, v.shape[3]) if v.ndim == 4 else (v.shape[2], v.shape[3])
        crop = sample_crop_params(np.random.default_rng((self.cfg.train.seed + 17, step)),
                                  v.shape[0], h, w, self.cfg.data.min_scale,
                                  self.cfg.data.max_scale)
        return torch.from_numpy(crop).to(self.device)

    def dropout_key(self, step: int | None = None) -> tuple:
        """The LoRA dropout key of micro-step ``step`` (default: the next)."""
        return (self.cfg.train.seed + 29, self.global_step if step is None else step)

    def train_step(self, batch) -> torch.Tensor:
        """One micro-step on ``batch``; returns the loss, on the device."""
        model, tc = self.model, self.cfg.train
        arrays = model.device_arrays(model.loss_arrays(batch))
        crop = self._sample_crops(batch)
        key = self.dropout_key() if model.cfg.lora.dropout > 0 else None
        n_frms = int(batch.timestamps.shape[1])
        if self.split_encode:
            with record_function("encode"), torch.no_grad():
                modal = model._encode_modality_tokens(*arrays[:4], n_frms, crop_params=crop)
        with record_function("loss_fwd_bwd"):
            if self.split_encode:
                loss = model._loss_from_tokens(modal, *arrays[4:], dropout_key=key)
            else:
                loss = model._loss_fn(*arrays, crop_params=crop, dropout_key=key, n_frms=n_frms)
            leaves = list(self.trainable.values())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(self.trainable.items(), grads)}
        with record_function("optimizer"):
            good = torch.isfinite(loss) if tc.nan_guard else None
            self.opt.step(self.trainable, grads, good)
        return loss.detach()

    # ------------------------------------------------------------------

    def _restore_sigterm(self) -> None:
        """Hand SIGTERM back to its owner before this trainer."""
        if not self._sigterm_installed:
            return
        try:
            signal.signal(signal.SIGTERM, self._prev_sigterm if self._prev_sigterm is not None
                          else signal.SIG_DFL)
        except ValueError:
            pass  # not the main thread
        self._sigterm_installed = False

    def train(self) -> dict:
        try:
            return self._train()
        finally:
            self._restore_sigterm()

    def _train(self) -> dict:
        tc = self.cfg.train
        best_metric, best_epoch = 0.0, 0
        results = {}
        try:
            for epoch in range(self.start_epoch, tc.max_epoch):
                self.train_epoch(epoch)
                if epoch % tc.val_freq == 0:
                    metrics = self.eval_epoch()
                    agg = metrics["brief"]["MR-full-R1-avg"]
                    logger.info("MR performance at epoch %d: %s", epoch, agg)
                    self.runlog.log("val", epoch=epoch,
                                    **{k: float(v) for k, v in metrics["brief"].items()})
                    results[epoch] = agg
                    if agg > best_metric:
                        best_epoch, best_metric = epoch, agg
                        self._save_checkpoint(epoch, is_best=True)
                if tc.save_freq > 0 and epoch % tc.save_freq == 0:
                    self._save_checkpoint(epoch, is_best=False)
        except Preempted as e:
            logger.info("training preempted cleanly: %s", e)
            return {"best_epoch": best_epoch, "best_metric": best_metric, "results": results,
                    "preempted": True, "preempt_ckpt": self._preempt_path}
        return {"best_epoch": best_epoch, "best_metric": best_metric, "results": results}

    def train_epoch(self, epoch: int) -> dict:
        self.train_loader.set_epoch(epoch)
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
        metric_logger.add_meter("loss", SmoothedValue(window_size=1, fmt="{value:.4f}"))
        logger.info("Start training epoch %d, %d iters per inner epoch.",
                    epoch, len(self.train_loader))
        # mid-epoch resume: the order is deterministic in (seed, epoch), the
        # crops and dropout keys in the step, so skipping the consumed
        # batches continues the stream bitwise
        skip, self._skip_steps = self._skip_steps, 0
        self._step_in_epoch = skip
        for i, batch in enumerate(self.train_loader.iter_from(skip), start=skip):
            loss = self.train_step(batch)
            self.global_step += 1
            self._step_in_epoch = i + 1
            self._flush_pending()
            self._pending = (loss, self.global_step, epoch, metric_logger)
            if self._preempt_requested:
                self._preempt_exit(epoch)
        self._flush_pending()
        logger.info("Averaged stats: %s", metric_logger.global_avg())
        return {k: f"{meter.global_avg:.3f}" for k, meter in metric_logger.meters.items()}

    def _flush_pending(self) -> None:
        """Read the last micro-step's loss on the host and account for it
        (LR, nan-guard count, run log)."""
        if self._pending is None:
            return
        loss_t, step, epoch, metric_logger = self._pending
        self._pending = None
        loss = float(loss_t)
        lr = float(self.schedule(step - 1))
        tc = self.cfg.train
        if not np.isfinite(loss):
            self._nan_skips += 1
            if tc.nan_guard:
                logger.warning("non-finite loss at step %d (%d consecutive); gradients zeroed, "
                               "update skipped", step, self._nan_skips)
            else:
                logger.warning("non-finite loss at step %d (%d consecutive); "
                               "train.nan_guard=False — the NaN update WAS applied",
                               step, self._nan_skips)
            self.runlog.log("nan_skip", step=step, epoch=epoch, consecutive=self._nan_skips,
                            guarded=tc.nan_guard)
            if tc.nan_guard and self._nan_skips >= tc.max_nan_skips:
                raise RuntimeError(
                    f"{self._nan_skips} consecutive non-finite losses "
                    f"(train.max_nan_skips={tc.max_nan_skips}); aborting instead of writing "
                    "NaN checkpoints")
        else:
            self._nan_skips = 0
        metric_logger.update(loss=loss, lr=lr)
        self.runlog.log("train_step", step=step, epoch=epoch, loss=loss, lr=lr)

    def _preempt_exit(self, epoch: int):
        """Save ``checkpoint_preempt`` at the exact step position and stop."""
        self._flush_pending()
        self._preempt_path = self._save_checkpoint(epoch, is_best=False, name="preempt")
        self.runlog.log("preempt", epoch=epoch, step=self.global_step,
                        step_in_epoch=self._step_in_epoch)
        raise Preempted(f"SIGTERM at epoch {epoch} step {self.global_step} "
                        f"({self._step_in_epoch} steps into the epoch); state saved to "
                        f"{self._preempt_path}")

    def eval_epoch(self) -> dict:
        """Generate on the val split and score the records against
        themselves; with the saliency head, the HL metrics too."""
        from mraudio_tpu_torch.infer.evaluate import saliency_to_clip_grid

        want_saliency = bool(getattr(self.model.cfg, "saliency_head", False))
        gt_by_qid = {a["qid"]: a for a in self.val_loader.dataset.annotation}
        results = []
        for batch in self.val_loader:
            saliency = None
            if want_saliency:
                outputs, saliency = self.model.generate(batch=batch, return_saliency=True)
            else:
                outputs = self.model.generate(batch=batch)
            for row, (qid, query, vid, target, output, valid) in enumerate(zip(
                    batch.qid, batch.query, batch.vid, batch.text_output, outputs, batch.valid)):
                if not valid:
                    continue
                record = {
                    "qid": qid, "query": query, "vid": vid,
                    "relevant_windows": moment_str_to_list(post_process(target)),
                    "pred_relevant_windows": moment_str_to_list(post_process(output)),
                }
                ann = gt_by_qid.get(qid, {})
                if saliency is not None and "saliency_scores" in ann:
                    record["pred_saliency_scores"] = saliency_to_clip_grid(
                        batch.timestamps[row], saliency[row], ann["duration"])
                    record["saliency_scores"] = ann["saliency_scores"]
                    record["duration"] = ann["duration"]
                    record["relevant_clip_ids"] = ann.get(
                        "relevant_clip_ids", list(range(len(ann["saliency_scores"]))))
                results.append(record)
        return eval_submission(results, results, verbose=False)

    # ------------------------------------------------------------------

    def _save_checkpoint(self, epoch: int, is_best: bool, name: str | None = None) -> str:
        if name is None:
            name = "best" if is_best else str(epoch)
        path = ckpt.save_checkpoint(self.cfg.train.output_dir, name, self.trainable,
                                    self.opt.state_dict(), epoch)
        # the exact step position: a resume continues the LR schedule and
        # the dropout and crop streams, and (preempt) skips the consumed
        # part of the epoch
        step_in_epoch = self._step_in_epoch if name == "preempt" else 0
        with open(path + ckpt.META_SUFFIX, "w") as f:
            json.dump({"epoch": epoch, "global_step": self.global_step,
                       "step_in_epoch": step_in_epoch}, f)
        logger.info("Saving checkpoint at epoch %d to %s.", epoch, path)
        return path

    @torch.no_grad()
    def _overlay(self, restored: dict) -> None:
        for k, p in self.trainable.items():
            p.copy_(restored[k])

    def _load_checkpoint(self, path: str) -> None:
        if "://" in path:
            raise NotImplementedError("resuming from a URL is not ported yet "
                                      "(ROADMAP.md A.10: utils/fetch.py)")
        path = ckpt.resolve_path(path)
        payload = ckpt.load_checkpoint(path)
        self._overlay(payload["model"])
        self.opt.load_state_dict(payload["opt_state"])
        epoch = int(payload["epoch"])
        meta = None
        if os.path.exists(path + ckpt.META_SUFFIX):
            with open(path + ckpt.META_SUFFIX) as f:
                meta = json.load(f)
        if meta is not None:
            self.global_step = int(meta["global_step"])
            self._skip_steps = int(meta["step_in_epoch"])
            # preempt saves resume inside their epoch, the others at the next
            self.start_epoch = epoch if self._skip_steps > 0 else epoch + 1
        else:
            self.start_epoch = epoch + 1
            self.global_step = self.start_epoch * self.steps_per_epoch
        logger.info("Resume checkpoint from %s (epoch %d, step %d, skip %d)",
                    path, self.start_epoch, self.global_step, self._skip_steps)
