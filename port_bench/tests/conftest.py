"""Shared pieces of the harness's tests: tiny configurations of both
families (every width cut, CPU-sized) and the small traffic overrides."""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(latent_dim=32, embed_dim=32, obs_dim=32, goal_dim=16, clip_embed_dim=16,
            n_enc_layers=1, n_dec_layers=1, n_heads=2, perceiver_dim=32, perceiver_depth=1,
            perceiver_heads=2, perceiver_dim_head=8, num_latents=3, img_size=32, vit_patch=16,
            vit_depth=1, vit_heads=2, clip_vision_width=64, clip_vision_layers=1,
            clip_vision_patch=16, clip_text_width=16, clip_text_layers=1, clip_text_heads=2,
            gen_img_res=32, gen_patch_size=16, gen_decoder_depth=1, gen_decoder_dim=16,
            gen_decoder_heads=2)

SMALL = {"mdtv-controller-b1": {}, "mdt-eval-b32": {"envs": 4},
         "mdtv-train-b512": {"batch_per_stream": 4, "static_hw": 40, "gripper_hw": 20},
         "mdt-train-b512": {"batch_per_stream": 4, "static_hw": 40, "gripper_hw": 20}}


def tiny_cfg(family: str, dtype: str = "float32"):
    from mdt_policy_tpu_torch.agents import MDTConfig, MDTVConfig
    cls = MDTVConfig if family == "mdtv" else MDTConfig
    return cls(**TINY, compute_dtype=dtype, gen_compute_dtype=dtype)


def run_tiny(cell: str, seed: int = 12345678901, dtype: str = "float32", trace: bool = False,
             seconds: float = 1.0, root: Path = ROOT, limits=None):
    from port_bench.harness.bench import Bench
    from port_bench.harness.runner import run_cell
    bench = Bench(root)
    family = bench.cell(cell)["config"]
    return run_cell(bench, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    agent_cfg=tiny_cfg(family, dtype), limits=limits,
                    traffic=SMALL.get(cell, {}))


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
