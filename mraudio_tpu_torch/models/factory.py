"""Model factory: the ``--model`` name → the backbone module (the JAX
package's ``models/factory.py``).

The reference dispatches on ``args.model`` in both entry points
(``evaluate.py:27-31``, ``utils/trainer.py:50-56``): X-InstructBLIP,
or VideoLLaMA built from the same size knobs
(``videollama.videollama_config_from``).  :func:`build_model` allocates
its parameters without values: ``convert_weights.load_pretrained_params`` (seeded init
plus the checkpoints the config names) or a param store fills them.
"""

from __future__ import annotations

from mraudio_tpu_torch.config import RunConfig


def canonical_model_name(name: str) -> str:
    key = name.lower().replace("-", "").replace("_", "").replace(" ", "")
    if key in ("xinstructblip", "instructblip", "x"):
        return "X-InstructBLIP"
    if key in ("videollama", "videollama2", "videollama2av"):
        return "VideoLLaMA"
    raise ValueError(f"unknown model {name!r} (expected X-InstructBLIP or VideoLLaMA)")


def build_model(cfg: RunConfig, device="cuda", llm_tokenizer=None):
    """The backbone named by ``cfg.model_name`` on ``device``, its
    parameters allocated but not filled."""
    if canonical_model_name(cfg.model_name) == "X-InstructBLIP":
        from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP

        return XInstructBLIP(cfg.model, audio_cfg=cfg.data.audio,
                             llm_tokenizer=llm_tokenizer, device=device)
    from mraudio_tpu_torch.models.videollama import VideoLLaMA, videollama_config_from

    return VideoLLaMA(videollama_config_from(cfg.model, cfg.data.n_frms),
                      audio_cfg=cfg.data.audio, llm_tokenizer=llm_tokenizer, device=device)
