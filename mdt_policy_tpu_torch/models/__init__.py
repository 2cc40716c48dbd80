"""Networks of the port."""

from .blocks import ClipStyleProjection
from .clip import CLIPTextTower, CLIPVisionTower
from .masked_decoder import MaskedTransformerImgDecoder
from .mdtv_transformer import MDTVTransformer
from .perceiver import PerceiverResampler
from .voltron_vit import VoltronViT

__all__ = ["ClipStyleProjection", "CLIPTextTower", "CLIPVisionTower",
           "MaskedTransformerImgDecoder", "MDTVTransformer",
           "PerceiverResampler", "VoltronViT"]
