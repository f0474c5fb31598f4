"""The port's FLOP accounting (``utils/flops.py``) gives the JAX package's
numbers exactly, on the tiny and the full configurations, and its peak
table knows the H100."""

import pytest

from mraudio_tpu.config import full_model_config as j_full
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.config import AudioFrontendConfig as JAudio
from mraudio_tpu.utils import flops as jflops
from mraudio_tpu_torch.config import AudioFrontendConfig, full_model_config, tiny_data_config
from mraudio_tpu_torch.config import tiny_model_config
from mraudio_tpu_torch.utils import flops

CONFIGS = {
    "tiny": (lambda: (j_tiny(), j_tiny_data().audio), lambda: (tiny_model_config(),
                                                                tiny_data_config().audio)),
    "full": (lambda: (j_full(), JAudio()), lambda: (full_model_config(), AudioFrontendConfig())),
    "full_residual": (
        lambda: (j_full().replace(vit=j_full().vit.replace(keyframe_interval=4)), JAudio()),
        lambda: (full_model_config().replace(vit=full_model_config().vit.replace(
            keyframe_interval=4)), AudioFrontendConfig())),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_same_numbers_as_jax(name):
    (jm, ja), (tm, ta) = CONFIGS[name][0](), CONFIGS[name][1]()
    for n_frms, batch in ((4, 1), (60, 2)):
        s = flops.prefill_length(tm, n_frms)
        assert s == jflops.prefill_length(jm, n_frms)
        assert flops.pipeline_flops(tm, ta, n_frms, batch, s, 64) == \
            jflops.pipeline_flops(jm, ja, n_frms, batch, s, 64)
        for remat in (True, False):
            assert flops.train_step_flops(tm, ta, n_frms, batch, s + 192, remat) == \
                jflops.train_step_flops(jm, ja, n_frms, batch, s + 192, remat)
    for args in ((100, 64, 2, 128), (5000, 4096, 32, 11008, 2500.0, 4096, 3)):
        assert flops.transformer_flops(*args) == jflops.transformer_flops(*args)


def test_peak_of_the_h100():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "h100"):
        assert flops.peak_flops_for(name) == 989e12
    with pytest.raises(KeyError, match="no bf16 peak"):
        flops.peak_flops_for("TPU v5 lite")
