"""Masked generative foresight decoder (port of
`mdt_policy_tpu/models/masked_decoder.py`, MAE-style): from the denoiser's
encoder context, reconstruct the masked patches of two future camera frames
(gen_static and gen_gripper at 112 px, patch 16: 49 patches each).

Kept from the JAX module: NHWC images; one random mask shared by both
frames, made by argsort of a uniform draw (B, n_patches) with a fixed
`n_keep`, which the caller passes in; mask 0 = keep, 1 = masked; the decoder
position table added twice (before the mask and after the unshuffle); the
per-frame `ctx_dec_pe`; loss = per-patch MSE on the masked patches, averaged
over the two frames, in float32.

`dtype` is the computation dtype (the production `gen_compute_dtype` is
bf16): the f32 master weights are cast to it, as flax `dtype=` does. The
blocks are Voltron blocks with plain attention (`fused_kernel=False`, as in
the JAX decoder); their RMSNorms and `decoder_norm` run kernel B3.

Key layout is the reference's (`patch2embed.proj`, `encoder2decoder`,
`mask_token`, `ctx_dec_pe`, `decoder_blocks.{i}`, `decoder_norm.g`,
`decoder_patch_prediction`), the one `port_masked_decoder` reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .blocks import RMSNorm, dense
from .voltron_vit import PatchEmbed, VoltronBlock, get_2d_sincos_pos_embed

__all__ = ["MaskedTransformerImgDecoder", "reconstruct_images"]


class MaskedTransformerImgDecoder(nn.Module):

    def __init__(self, resolution: int = 112, patch_size: int = 16,
                 decoder_depth: int = 6, decoder_embed_dim: int = 192,
                 decoder_n_heads: int = 8, context_dim: int = 384,
                 in_channels: int = 3, mask_ratio: float = 0.75,
                 num_images: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        D = decoder_embed_dim
        self.resolution, self.patch_size, self.in_channels = resolution, patch_size, in_channels
        self.num_images, self.dtype = num_images, dtype
        self.num_patches = (resolution // patch_size) ** 2
        self.n_keep = int(self.num_patches * (1 - mask_ratio))
        self.patch2embed = PatchEmbed(patch_size, D, in_channels, dtype=dtype)
        self.encoder2decoder = nn.Linear(context_dim, D)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, D))
        self.ctx_dec_pe = nn.Parameter(torch.zeros(1, num_images, 1, D))
        self.decoder_blocks = nn.ModuleList(
            VoltronBlock(D, decoder_n_heads, fused_kernel=False, dtype=dtype)
            for _ in range(decoder_depth))
        self.decoder_norm = RMSNorm(D, dtype=dtype)
        self.decoder_patch_prediction = nn.Linear(D, patch_size ** 2 * in_channels)
        pe = get_2d_sincos_pos_embed(D, resolution // patch_size)
        self.register_buffer("decoder_pe", torch.from_numpy(pe)[None],
                             persistent=False)

    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype is None else t.to(self.dtype)

    def _dense(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        return layer(x) if self.dtype is None else dense(x, layer, self.dtype)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, t, H, W, C) -> (B, t, n_patches, ph*pw*C), patches row-major,
        values (ph, pw, c) within a patch (the reference's target layout)."""
        B, t, H, W, C = imgs.shape
        p = self.patch_size
        x = imgs.reshape(B, t, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(B, t, (H // p) * (W // p), p * p * C)

    def mask(self, ctx_patches: torch.Tensor, noise: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Symmetric random masking from a uniform draw `noise` (B, n_patches).
        Returns (visible (B, t, n_keep, d), mask (B, n_patches) 0 = keep,
        restore_idxs (B, n_patches))."""
        B, t, n, d = ctx_patches.shape
        if tuple(noise.shape) != (B, n):
            raise ValueError(f"mask noise must be {(B, n)}, got {tuple(noise.shape)}")
        shuffle = torch.argsort(noise, dim=1, stable=True)
        restore = torch.argsort(shuffle, dim=1, stable=True)
        keep = shuffle[:, :self.n_keep]
        visible = torch.gather(ctx_patches, 2,
                               keep[:, None, :, None].expand(B, t, self.n_keep, d))
        mask = torch.ones((B, n), dtype=ctx_patches.dtype, device=ctx_patches.device)
        mask[:, :self.n_keep] = 0.0
        return visible, torch.gather(mask, 1, restore), restore

    def forward(self, context: torch.Tensor, target_images: torch.Tensor,
                mask_noise: torch.Tensor):
        """context (B, ctx_tokens, context_dim); target_images (B, t, H, W, C);
        mask_noise (B, n_patches) uniform. Returns (recon (B, t, n_patches,
        p*p*C), mask, restore_idxs, visible)."""
        B, t = target_images.shape[:2]
        D = self.mask_token.shape[-1]
        emb_context = self._dense(context, self.encoder2decoder)
        patches = self.patch2embed(target_images.reshape((B * t,) + tuple(target_images.shape[2:])))
        dec_pe = self._cast(self.decoder_pe)
        ctx_patches = (patches + dec_pe).reshape(B, t, self.num_patches, D)
        visible_ctx, mask, restore = self.mask(ctx_patches, mask_noise)

        n_masked = self.num_patches - self.n_keep
        mask_tokens = self._cast(self.mask_token)[:, None].expand(B, t, n_masked, D)
        concatenated = torch.cat([visible_ctx, mask_tokens], dim=2)
        unshuffled = torch.gather(concatenated, 2,
                                  restore[:, None, :, None].expand(B, t, self.num_patches, D))
        # position table added a second time, plus the per-frame embedding
        dec_patches = unshuffled + dec_pe[None] + self._cast(self.ctx_dec_pe[:, :t])
        x = torch.cat([emb_context, dec_patches.reshape(B, t * self.num_patches, D)], dim=1)
        for block in self.decoder_blocks:
            x = block(x)
        tokens = self.decoder_norm(x)
        recon = self._dense(tokens[:, emb_context.shape[1]:], self.decoder_patch_prediction)
        return (recon.reshape(B, t, self.num_patches, -1), mask, restore,
                visible_ctx.reshape(B, t * self.n_keep, D))

    def compute_loss(self, imgs: torch.Tensor, reconstructions: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        """Per-patch MSE on the masked patches, averaged over the two frames,
        in float32 whatever the decoder's dtype."""
        targets = self.patchify(imgs).float()
        recon, mask = reconstructions.float(), mask.float()
        per_patch = ((recon - targets) ** 2).mean(-1)  # (B, t, n_patches)
        denom = mask.sum().clamp_min(1.0)
        zero_loss = (per_patch[:, 0] * mask).sum() / denom
        k_loss = (per_patch[:, 1] * mask).sum() / denom
        return (zero_loss + k_loss) / 2


def reconstruct_images(decoder: MaskedTransformerImgDecoder, predictions: torch.Tensor,
                       goal_images: torch.Tensor, mask: torch.Tensor, file_path=None):
    """A grid of the first sample's frames side by side: masked patches
    replaced by the predictions, visible patches kept from the target, the
    CLIP normalization undone (JAX `reconstruct_images`,
    masked_decoder.py:165-204; ref reconstruct_image,
    masked_transformer_decoder.py:304-373). Host-side numpy and PIL, which
    is imported here only.

    predictions: (B, num_images, n_patches, ph*pw*C); goal_images:
    (B, num_images, H, W, C) CLIP-normalized; mask: (B, n_patches), 1 =
    masked. Returns the PIL image (saved to file_path when given)."""
    from PIL import Image

    from ..data.transforms import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    preds = predictions.detach().float().cpu().numpy()
    targets = decoder.patchify(goal_images.detach().float()).cpu().numpy()
    mask_np = mask.detach().float().cpu().numpy()
    n_img = preds.shape[1]
    ph = pw = decoder.patch_size
    grid = decoder.resolution // decoder.patch_size
    c = decoder.in_channels

    tiles = []
    for img_idx in range(n_img):
        combined = targets[0, img_idx].copy()
        combined[mask_np[0] == 1] = preds[0, img_idx][mask_np[0] == 1]
        img = combined.reshape(grid, grid, ph, pw, c)
        img = img.transpose(0, 2, 1, 3, 4).reshape(grid * ph, grid * pw, c)
        img = img * np.asarray(CLIP_IMAGE_STD) + np.asarray(CLIP_IMAGE_MEAN)
        tiles.append(np.clip(img, 0, 1))
    out = (np.concatenate(tiles, axis=1) * 255).astype(np.uint8)
    pil = Image.fromarray(out)
    if file_path is not None:
        pil.save(file_path)
    return pil
