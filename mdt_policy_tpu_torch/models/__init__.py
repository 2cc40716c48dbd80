"""Networks of the port."""

from .blocks import ClipStyleProjection
from .clip import CLIPTextTower, CLIPVisionTower
from .masked_decoder import MaskedTransformerImgDecoder
from .mdt_transformer import MDTTransformer
from .mdtv_transformer import MDTVTransformer
from .perceiver import PerceiverResampler
from .resnet import BesoResNetEncoder, ResNet18GN, SpatialSoftmax
from .voltron_vit import VoltronViT

__all__ = ["BesoResNetEncoder", "ClipStyleProjection", "CLIPTextTower",
           "CLIPVisionTower", "MaskedTransformerImgDecoder", "MDTTransformer",
           "MDTVTransformer", "PerceiverResampler", "ResNet18GN",
           "SpatialSoftmax", "VoltronViT"]
