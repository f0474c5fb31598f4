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
* ``train.quant_frozen="int8"``: every eligible frozen float kernel is
  stored int8 and dequantized where it is read
  (``models/quant_tree.py``), after the bf16 cast.
* ``train.encoder_window`` (W): the frozen encoders live in pinned host
  memory; each window of W batches uploads them in one packed copy per
  dtype (``utils/packing.py``), encodes its batches, drops the device
  copy, then runs the W loss steps with only the LLM's weights on the
  device.  The same computations on the same inputs in the same order as
  the per-batch split step (crops and dropout keys follow each batch's
  step), so the bits are its.  ``train.upload_overlap`` issues the next
  window's copies on a side stream while this window's loss steps run,
  when the card has 1.1x the packed bytes above the observed peak, and
  otherwise stays serialized (logged); each window's ``window`` run-log
  event says which path ran and whether an encoder leaf was on the
  device during its loss steps.
* Under ``scan_layers`` the checkpoints hold the decoder's leaves
  stacked, the JAX package's layout (``models/convert_jax.py::
  stack_layers``); the trainer's own leaves stay per layer.

On a mesh (``cfg.mesh``, one process per device, ``parallel/``): the
model's full parameters are sliced into this rank's shards after the
casts; each data rank's loaders yield its ``batch_size / data`` rows of
the global batch the JAX package's ``Trainer`` sees in one process, and
the crops are drawn for the global batch and sliced; each rank's loss is
its part of the global batch's mean, the gradients are summed over the
data ranks (and over the model ranks for the replicated LoRA leaves that
sharded compute feeds: a column projection's ``lora_a``, a row
projection's ``lora_b``); checkpoints hold the full leaves, which rank 0
alone writes, as it alone writes the run log.  ``encoder_window`` on a
mesh raises, as in the JAX package.

Both backbones train: X-InstructBLIP (LoRA, and the saliency head) and
VideoLLaMA (LoRA, the connector and the audio projector), each by its
``TRAINABLE_PATTERN``.  The encoders run apart only for a model that names
its ``ENCODER_PARAM_KEYS`` and has ``_loss_from_tokens``.
"""

from __future__ import annotations

import contextlib
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
from mraudio_tpu_torch.models.convert_jax import (flax_params, stack_layers, torch_name,
                                                  unstack_layers)
from mraudio_tpu_torch.parallel import (comm, gather_params, local_batch_size, mesh_for,
                                        shard_module_, shard_params)
from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process
from mraudio_tpu_torch.train import checkpoint as ckpt
from mraudio_tpu_torch.train.optim import (DEFAULT_TRAINABLE_PATTERN, build_optimizer,
                                           global_grad_norm, lavis_warmup_cosine_schedule,
                                           split_trainable)
from mraudio_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from mraudio_tpu_torch.utils.runlog import RunLogger

logger = logging.getLogger("mraudio_tpu_torch")


class Preempted(RuntimeError):
    """Raised after a SIGTERM-triggered save: the trainable leaves, the
    optimizer state and the exact step position are on disk as
    ``checkpoint_preempt``."""


def refuse_unported(cfg: RunConfig) -> None:
    """Raise for a training configuration the port does not run
    (``NotImplementedError`` naming the ROADMAP.md item) or nobody can."""
    from mraudio_tpu_torch.infer.evaluate import refuse_unported_mesh

    if cfg.train.quant_frozen not in ("none", "", "int8"):
        raise ValueError(f"unknown quant_frozen={cfg.train.quant_frozen!r}")
    if cfg.mesh.num_devices > 1 and cfg.train.encoder_window > 0:
        raise ValueError("train.encoder_window is a single-chip memory lever; "
                         "on a mesh shard the LLM over the `model` axis instead")
    refuse_unported_mesh(cfg)


class _NoRunLog:
    """The run log of a rank other than 0: nothing is written."""

    def log(self, event: str, **fields) -> None:
        pass


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
        self.mesh = mesh_for(cfg.mesh)
        self.local_batch = (tc.batch_size if self.mesh is None
                            else local_batch_size(tc.batch_size, self.mesh))
        if model is None:
            from mraudio_tpu_torch.infer.evaluate import build_model

            model = build_model(cfg, device)
        self.model = model
        self.trainable_pattern = getattr(model, "TRAINABLE_PATTERN", DEFAULT_TRAINABLE_PATTERN)
        params = dict(model.named_parameters())
        names, _ = split_trainable(flax_params(model, stacked=False), self.trainable_pattern)
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
        if tc.quant_frozen == "int8":
            from mraudio_tpu_torch.models.quant_tree import quantize_module_

            saved = quantize_module_(model, skip=set(self.trainable))
            logger.info("quant_frozen=int8: %.2f GB of frozen weights saved", saved / 2 ** 30)
        # on a mesh: each trainable leaf's spec; the leaves split over the
        # model ranks, and the replicated decoder leaves whose gradients
        # are partial sums over them
        self.specs, self._model_sharded, self._model_partial = {}, set(), []
        if self.mesh is not None:
            by_port = shard_module_(model, self.mesh)
            self.specs = {k: by_port[torch_name(tuple(k.split("/")))] for k in self.trainable}
            if self.mesh.model > 1:
                self._model_sharded = {k for k, spec in self.specs.items() if "model" in spec}
                self._model_partial = [k for k in self.trainable if k.startswith("llm/")
                                       and k not in self._model_sharded]
        enc_keys = getattr(model, "ENCODER_PARAM_KEYS", None)
        self.split_encode = (tc.split_encode_step and enc_keys is not None
                             and hasattr(model, "_loss_from_tokens")
                             and not any(k.split("/")[0] in enc_keys for k in self.trainable))
        self._windowed = tc.encoder_window > 0
        self._staged_enc = None            # the next window's staged copies
        self._overlap_ok = bool(tc.upload_overlap)
        if self._windowed:
            if not self.split_encode:
                raise ValueError("train.encoder_window requires split_encode_step=True and "
                                 "fully frozen encoder subtrees")
            self._enc_params = {n: p for n, p in model.named_parameters()
                                if n.split(".")[0] in enc_keys}
            from mraudio_tpu_torch.utils.packing import make_packed_uploader

            self._uploader, self._enc_nbytes = make_packed_uploader(
                {n: p.data for n, p in self._enc_params.items()}, self.device)
            self._encoders_to_host()
            logger.info("encoder_window=%d: packed encoder subtree %.2f GB on the host",
                        tc.encoder_window, self._enc_nbytes / 2 ** 30)

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
        rows = (None if self.mesh is None
                else (self.mesh.data_index * self.local_batch, self.local_batch))
        self.train_loader = BatchLoader(train_dataset, tc.batch_size, shuffle=True, seed=tc.seed,
                                        drop_last=True, num_threads=max(tc.num_workers, 1),
                                        rows=rows)
        self.val_loader = BatchLoader(val_dataset, tc.batch_size, shuffle=False,
                                      num_threads=max(tc.num_workers, 1), rows=rows)

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
        self.main = self.mesh is None or self.mesh.rank == 0
        self.runlog = RunLogger(tc.output_dir, "train") if self.main else _NoRunLog()
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
        # drawn for the global batch; a data rank takes its rows
        crop = sample_crop_params(np.random.default_rng((self.cfg.train.seed + 17, step)),
                                  self.cfg.train.batch_size, h, w, self.cfg.data.min_scale,
                                  self.cfg.data.max_scale)
        first = 0 if self.mesh is None else self.mesh.data_index * self.local_batch
        return torch.from_numpy(crop[first:first + v.shape[0]]).to(self.device)

    def dropout_key(self, step: int | None = None) -> tuple:
        """The LoRA dropout key of micro-step ``step`` (default: the next)."""
        return (self.cfg.train.seed + 29, self.global_step if step is None else step)

    def train_step(self, batch) -> tuple:
        """One micro-step on ``batch``; returns the loss and the gradient
        norm, on the device."""
        model = self.model
        arrays, crop, key, n_frms = self._step_inputs(batch, self.global_step)
        if self.split_encode:
            return self._loss_step(self._encode(arrays, crop, n_frms), arrays, key)
        with record_function("loss_fwd_bwd"):
            loss = model._loss_fn(*arrays, crop_params=crop, dropout_key=key, n_frms=n_frms)
            grads = self._grads(loss)
        return self._apply(loss, grads)

    def _step_inputs(self, batch, step: int) -> tuple:
        """Micro-step ``step``'s device arrays, crops, dropout key and frame
        count for ``batch``."""
        model = self.model
        arrays = model.device_arrays(model.loss_arrays(batch))
        key = self.dropout_key(step) if model.cfg.lora.dropout > 0 else None
        return arrays, self._sample_crops(batch, step), key, int(batch.timestamps.shape[1])

    def _encode(self, arrays, crop, n_frms) -> dict:
        with record_function("encode"), torch.no_grad():
            return self.model._encode_modality_tokens(*arrays[:4], n_frms, crop_params=crop)

    def _grads(self, loss) -> dict:
        """The trainable leaves' gradients; on a mesh summed over the data
        ranks, and over the model ranks for the replicated leaves that
        sharded compute feeds."""
        leaves = list(self.trainable.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.trainable.items(), grads)}
        if self.mesh is not None:
            comm.all_reduce_sum_(grads, self._model_partial, self.mesh.model_group)
            comm.all_reduce_sum_(grads, list(grads), self.mesh.data_group)
        return grads

    def _apply(self, loss, grads) -> torch.Tensor:
        """The optimizer step; returns the (global batch's) loss and the
        gradients' global norm, on the device."""
        if self.mesh is not None:
            loss = comm.all_reduce_sum(loss.detach(), self.mesh.data_group)
        norm = global_grad_norm(grads, self._model_sharded,
                                None if self.mesh is None else self.mesh.model_group)
        with record_function("optimizer"):
            good = torch.isfinite(loss) if self.cfg.train.nan_guard else None
            self.opt.step(self.trainable, grads, good)
        return loss.detach(), norm

    def _loss_step(self, modal: dict, arrays, key) -> tuple:
        """The LLM loss, its gradients and the update from encoded tokens."""
        with record_function("loss_fwd_bwd"):
            loss = self.model._loss_from_tokens(modal, *arrays[4:], dropout_key=key)
            grads = self._grads(loss)
        return self._apply(loss, grads)

    # ------------------------------------------------------------------
    # train.encoder_window: the frozen encoders on the host between windows

    @torch.no_grad()
    def _encoders_to_host(self) -> None:
        """Point every encoder leaf at its view of the packed host copy;
        the device copy goes with its last reference."""
        for n, p in self._enc_params.items():
            p.data = self._uploader.host[n]

    def encoders_on_device(self) -> bool:
        return any(p.device != torch.device("cpu") for p in self._enc_params.values())

    @torch.no_grad()
    def _encoders_to_device(self, staged=None) -> None:
        """One packed copy per dtype (or the copies ``staged`` earlier),
        then every encoder leaf a view into the device buffers."""
        views = self._uploader(staged)
        for n, p in self._enc_params.items():
            p.data = views[n]

    def _stage_encoders(self):
        """Issue the next window's copies now (``train.upload_overlap``),
        or return None and stay serialized when the card lacks 1.1x the
        packed bytes above the peak seen so far (its memory is what the
        loss steps sized) or the staging runs out of memory."""
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            limit = free + torch.cuda.memory_reserved(self.device)
            margin = limit - torch.cuda.max_memory_allocated(self.device)
            if margin < self._enc_nbytes * 1.1:
                logger.warning("upload_overlap: %.2f GB above the observed peak < 1.1x the "
                               "%.2f GB packed encoders; staying serialized",
                               margin / 2 ** 30, self._enc_nbytes / 2 ** 30)
                self._overlap_ok = False
                return None
        try:
            return self._uploader.stage()
        except torch.cuda.OutOfMemoryError:
            logger.warning("no device memory to double-buffer the encoder upload; falling "
                           "back to serialized per-window uploads")
            self._overlap_ok = False
            return None

    @contextlib.contextmanager
    def _encoders_resident(self):
        """The encoders on the device for the duration (validation)."""
        if not self._windowed:
            yield
            return
        self._encoders_to_device(self._staged_enc)
        self._staged_enc = None
        try:
            yield
        finally:
            self._encoders_to_host()

    def _train_epoch_windowed(self, epoch: int, metric_logger, skip: int) -> None:
        """Windows of W batches: upload the encoders, encode the window,
        drop the device copy, then the window's loss steps.  Each batch's
        crops and dropout key are those of the step it will run at."""
        w = self.cfg.train.encoder_window
        pending = []

        def flush(more: bool) -> None:
            if not pending:
                return
            staged = self._staged_enc is not None
            self._encoders_to_device(self._staged_enc)
            self._staged_enc = None
            modals = [self._encode(arrays, crop, n) for arrays, crop, _, n in pending]
            self._encoders_to_host()
            if more and self._overlap_ok:
                self._staged_enc = self._stage_encoders()
            on_device = self.encoders_on_device()
            allocated = (torch.cuda.memory_allocated(self.device)
                         if self.device.type == "cuda" else 0)
            for (arrays, _, key, _), modal in zip(pending, modals):
                loss = self._loss_step(modal, arrays, key)
                on_device = on_device or self.encoders_on_device()
                self.global_step += 1
                self._step_in_epoch += 1
                self._flush_pending()
                self._pending = (loss, self.global_step, epoch, metric_logger)
            self.runlog.log("window", epoch=epoch, step=self.global_step, batches=len(pending),
                            staged_upload=staged, next_staged=self._staged_enc is not None,
                            encoders_on_device_during_steps=on_device,
                            allocated_bytes_before_steps=allocated)
            pending.clear()
            if self._preempt_now():
                self._preempt_exit(epoch)

        for batch in self.train_loader.iter_from(skip):
            if len(pending) >= w:
                flush(more=True)
            pending.append(self._step_inputs(batch, self.global_step + len(pending)))
        flush(more=False)
        self._staged_enc = None

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
        if self._windowed:
            self._train_epoch_windowed(epoch, metric_logger, skip)
        else:
            for i, batch in enumerate(self.train_loader.iter_from(skip), start=skip):
                loss = self.train_step(batch)
                self.global_step += 1
                self._step_in_epoch = i + 1
                self._flush_pending()
                self._pending = (loss, self.global_step, epoch, metric_logger)
                if self._preempt_now():
                    self._preempt_exit(epoch)
        self._flush_pending()
        logger.info("Averaged stats: %s", metric_logger.global_avg())
        return {k: f"{meter.global_avg:.3f}" for k, meter in metric_logger.meters.items()}

    def _flush_pending(self) -> None:
        """Read the last micro-step's loss on the host and account for it
        (LR, nan-guard count, run log)."""
        if self._pending is None:
            return
        (loss_t, norm_t), step, epoch, metric_logger = self._pending
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
        self.runlog.log("train_step", step=step, epoch=epoch, loss=loss, lr=lr,
                        grad_norm=float(norm_t))

    def _preempt_now(self) -> bool:
        """Whether a SIGTERM arrived; on a mesh, at any rank (every rank
        then saves at the same step)."""
        if self.mesh is None:
            return self._preempt_requested
        flag = torch.tensor([float(self._preempt_requested)], device=self.device)
        return bool(comm.all_reduce_max(flag, torch.distributed.group.WORLD)[0] > 0)

    def _preempt_exit(self, epoch: int):
        """Save ``checkpoint_preempt`` at the exact step position and stop."""
        self._flush_pending()
        self._staged_enc = None
        self._preempt_path = self._save_checkpoint(epoch, is_best=False, name="preempt")
        self.runlog.log("preempt", epoch=epoch, step=self.global_step,
                        step_in_epoch=self._step_in_epoch)
        raise Preempted(f"SIGTERM at epoch {epoch} step {self.global_step} "
                        f"({self._step_in_epoch} steps into the epoch); state saved to "
                        f"{self._preempt_path}")

    def eval_epoch(self) -> dict:
        """Generate on the val split and score the records against
        themselves; with the saliency head, the HL metrics too.  Under
        ``encoder_window`` the encoders come to the device for it."""
        with self._encoders_resident():
            return self._eval_epoch()

    def _eval_epoch(self) -> dict:
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
        if self.mesh is not None:
            # every data rank's records; the model ranks of a data group
            # hold the same ones, and the first of them sends them
            results = _allgather_results(results if self.mesh.model_index == 0 else [])
        return eval_submission(results, results, verbose=False)

    # ------------------------------------------------------------------

    def _save_checkpoint(self, epoch: int, is_best: bool, name: str | None = None) -> str:
        """Write the checkpoint's full leaves (on a mesh every rank takes
        part in gathering them and rank 0 alone writes); returns its
        path."""
        if name is None:
            name = "best" if is_best else str(epoch)
        model, opt_state = self._full(self.trainable), self._full(self.opt.state_dict())
        path = os.path.abspath(os.path.join(self.cfg.train.output_dir, f"checkpoint_{name}"))
        if not self.main:
            return path
        ckpt.save_checkpoint(self.cfg.train.output_dir, name, self._layout(model),
                             self._layout(opt_state), epoch)
        # the exact step position: a resume continues the LR schedule and
        # the dropout and crop streams, and (preempt) skips the consumed
        # part of the epoch
        step_in_epoch = self._step_in_epoch if name == "preempt" else 0
        with open(path + ckpt.META_SUFFIX, "w") as f:
            json.dump({"epoch": epoch, "global_step": self.global_step,
                       "step_in_epoch": step_in_epoch}, f)
        logger.info("Saving checkpoint at epoch %d to %s.", epoch, path)
        return path

    def _leaf_spec(self, name: str) -> tuple:
        """The spec of a trainable leaf or of its optimizer state
        (``mu/<leaf>``, ...); counters are replicated."""
        return self.specs.get(name.split("/", 1)[-1] if name.startswith(("mu/", "nu/", "acc/"))
                              else name, ())

    def _full(self, flat: dict) -> dict:
        """The full leaves of a flat dict of this rank's shards."""
        if self.mesh is None:
            return flat
        return gather_params(flat, self.mesh, {k: self._leaf_spec(k) for k in flat})

    def _local(self, flat: dict) -> dict:
        """This rank's shards of a flat dict of full leaves."""
        if self.mesh is None:
            return flat
        return shard_params(flat, self.mesh, {k: self._leaf_spec(k) for k in flat})

    def _layout(self, flat: dict) -> dict:
        """A flat dict of per-layer names in the checkpoint's layout: the
        decoder's leaves stacked under ``scan_layers`` (also inside the
        optimizer's ``mu/``, ``nu/`` and ``acc/`` names)."""
        llm = getattr(self.model, "llm", None)
        if llm is None or not llm.cfg.scan_layers:
            return flat
        for prefix in ("llm", "mu/llm", "nu/llm", "acc/llm"):
            flat = stack_layers(flat, prefix, llm.cfg.num_layers)
        return flat

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
        self._overlay(self._local(unstack_layers(payload["model"])))
        self.opt.load_state_dict(self._local(unstack_layers(payload["opt_state"])))
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



# the JAX package's name for the ragged gather of eval records across
# processes (the reference's ``DistributedSampler`` val split)
_allgather_results = comm.allgather_results
