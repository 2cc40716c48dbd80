"""MiniLM sentence encoder (port of `mdt_policy_tpu/models/minilm.py`): a
post-LN BERT encoder and attention-masked mean pooling, the
sentence-transformers paraphrase-MiniLM family whose 384-d embeddings the
published CALVIN `lang_paraphrase-MiniLM` folders carry (reference
`mdt/utils/automatic_lang_annotator_mp.py:321-342`).

`MiniLMEncoder` holds HF `BertModel`'s key layout (`embeddings.*`,
`encoder.layer.{i}.attention.self.query.*`, ...), so a published folder's
weights load with `load_state_dict` after `port_minilm_weights` normalises
their prefixes (bare, `bert.`, `0_Transformer.`) and drops the pooler.
Erf GELU; LayerNorm eps from the config (1e-12), through kernel B3
(`TowerLayerNorm`, as the port's other frozen towers), f32 rows; the
padding mask goes through `ops/attention.py::sdpa(mask=)`.

`minilm_embed_fn(model_dir, device=None)` wires a local folder
(config.json, `pytorch_model.bin` or `model.safetensors`, vocab.txt) into
the annotator's `embed(sentence)`, on the card unless `device` names the
CPU, with the port's own WordPiece tokenizer (`utils/bert_tokenizer.py`)
and safetensors reader (`utils/safetensors_io.py`): neither `transformers`
nor `safetensors` is needed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from .blocks import TowerLayerNorm


__all__ = ["MiniLMEncoder", "port_minilm_weights", "minilm_embed_fn", "MINILM_L3_CONFIG"]

# paraphrase-MiniLM-L3-v2, the family of the published CALVIN
# `lang_paraphrase-MiniLM` folders (384-d sentence embeddings)
MINILM_L3_CONFIG = dict(vocab_size=30522, hidden_size=384, num_layers=3, num_heads=12,
                        intermediate_size=1536, max_position_embeddings=512,
                        type_vocab_size=2, layer_norm_eps=1e-12)


def _dense_ln(width_in: int, width_out: int, eps: float) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": nn.Linear(width_in, width_out),
                          "LayerNorm": TowerLayerNorm(width_out, eps=eps)})


class _BertLayer(nn.Module):
    """Post-LN BERT block: attention, add and norm, GELU FFN, add and norm."""

    def __init__(self, hidden: int, heads: int, intermediate: int, eps: float):
        super().__init__()
        self.num_heads = heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: nn.Linear(hidden, hidden)
                                   for n in ("query", "key", "value")}),
            "output": _dense_ln(hidden, hidden, eps)})
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(hidden, intermediate)})
        self.output = _dense_ln(intermediate, hidden, eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        proj = self.attention["self"]
        q, k, v = (proj[n](x).reshape(B, T, self.num_heads, C // self.num_heads)
                   for n in ("query", "key", "value"))
        attn = sdpa(q, k, v, mask=mask, layout="bthd").reshape(B, T, C)
        out = self.attention["output"]
        x = out["LayerNorm"](x + out["dense"](attn))
        h = F.gelu(self.intermediate["dense"](x))
        return self.output["LayerNorm"](x + self.output["dense"](h))


class MiniLMEncoder(nn.Module):
    """(input_ids, attention_mask) (B, T) -> (B, hidden_size) sentence
    embeddings: BERT, then the masked mean of the last hidden states
    (divided by the mask's sum clamped at 1e-9; paraphrase-MiniLM applies no
    output normalization). Row 0 of `token_type_embeddings` is added."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 384, num_layers: int = 3,
                 num_heads: int = 12, intermediate_size: int = 1536,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12):
        super().__init__()
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(vocab_size, hidden_size),
            "position_embeddings": nn.Embedding(max_position_embeddings, hidden_size),
            "token_type_embeddings": nn.Embedding(type_vocab_size, hidden_size),
            "LayerNorm": TowerLayerNorm(hidden_size, eps=layer_norm_eps)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            _BertLayer(hidden_size, num_heads, intermediate_size, layer_norm_eps)
            for _ in range(num_layers))})

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        emb = self.embeddings
        x = (emb["word_embeddings"](input_ids) + emb["position_embeddings"].weight[None, :T]
             + emb["token_type_embeddings"].weight[0][None, None])
        x = emb["LayerNorm"](x)
        mask = attention_mask[:, None, None, :].bool()  # every query sees real tokens only
        for layer in self.encoder["layer"]:
            x = layer(x, mask)
        m = attention_mask[..., None].to(x.dtype)
        return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)


def port_minilm_weights(sd: Mapping) -> Dict[str, torch.Tensor]:
    """An HF `BertModel` state_dict, bare (`embeddings.*`) or prefixed
    (`bert.`, sentence-transformers' `0_Transformer.`), as float32 tensors
    under `MiniLMEncoder`'s keys; the pooler and the id buffers
    (`embeddings.position_ids`, `embeddings.token_type_ids`) are dropped."""
    def f32(v):
        return v.detach().to("cpu", torch.float32) if torch.is_tensor(v) \
            else torch.from_numpy(np.asarray(v, np.float32))

    for pfx in ("bert.", "0_Transformer."):
        sd = {k[len(pfx):] if k.startswith(pfx) else k: v for k, v in sd.items()}
    return {k: f32(v) for k, v in sd.items()
            if not k.startswith("pooler.") and not k.endswith("_ids")}


def _load_state_dict(model_dir: Path):
    """`pytorch_model.bin` (torch) or `model.safetensors` of a local folder."""
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    st_path = model_dir / "model.safetensors"
    if st_path.exists():
        from ..utils.safetensors_io import load_safetensors
        return load_safetensors(st_path)
    raise FileNotFoundError(f"no pytorch_model.bin or model.safetensors under {model_dir}")


def minilm_embed_fn(model_dir, device=None):
    """`embed(sentence) -> (hidden_size,) float32` from a LOCAL MiniLM folder
    (what `SentenceTransformer.save` or HF `save_pretrained` write; a
    sentence-transformers folder whose `config.json` sits in a nested
    `*Transformer*` folder is followed there), on `device` (default: CUDA;
    the CPU only when named)."""
    from ..agents.mdtv_agent import default_device
    from ..utils.bert_tokenizer import BertTokenizer

    device = default_device(device)
    model_dir = Path(model_dir)
    if not (model_dir / "config.json").exists():
        nested = sorted(model_dir.glob("*Transformer*"))
        if nested:
            model_dir = nested[0]
    hf = json.loads((model_dir / "config.json").read_text())
    enc = MiniLMEncoder(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"], num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12))
    enc.load_state_dict(port_minilm_weights(_load_state_dict(model_dir)), strict=True)
    enc = enc.to(device).eval().requires_grad_(False)
    tok = BertTokenizer(model_dir / "vocab.txt", do_lower_case=hf.get("do_lower_case", True))
    max_len = min(hf["max_position_embeddings"], 128)

    def embed(sentence: str) -> np.ndarray:
        out = tok([sentence], max_len)
        with torch.no_grad():
            e = enc(torch.from_numpy(out["input_ids"]).to(device),
                    torch.from_numpy(out["attention_mask"]).to(device))
        return e[0].cpu().numpy()

    return embed
