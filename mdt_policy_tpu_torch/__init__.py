"""PyTorch/CUDA port of `mdt_policy_tpu` for one NVIDIA H100.

The JAX package stays the reference; this package imports `torch` and never
`jax`. Slice 1 covers the MDT-V closed-loop replan: Voltron ViT, perceiver
resampler, CLIP text tower, MDTVTransformer and the DDIM sampler, with the
towers' attention on the hand-written CUDA kernel in `csrc/`.
"""

__version__ = "0.1.0"
