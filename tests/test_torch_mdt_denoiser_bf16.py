"""One train step of the MDT (ResNet) agent's bf16 denoiser against the
JAX package's bf16 and f32 steps, at the bounds that
tests/test_torch_denoiser_configs.py states for the bf16 denoiser (the
losses; the gradients, the AdamW updates and the EMA over all trainable
leaves against JAX's f32 step; each leaf against JAX's bf16 step)."""

from test_torch_denoiser_configs import check_train_step


def test_mdt_bf16_denoiser_train_step_matches_jax():
    check_train_step("bf16_denoiser", "mdt")
