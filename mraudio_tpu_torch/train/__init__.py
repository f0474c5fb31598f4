"""LoRA fine-tuning: the optimizer and schedule, checkpoints, the trainer."""
