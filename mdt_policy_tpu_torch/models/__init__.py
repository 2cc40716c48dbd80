"""Networks of the port."""

from .clip import CLIPTextTower
from .mdtv_transformer import MDTVTransformer
from .perceiver import PerceiverResampler
from .voltron_vit import VoltronViT

__all__ = ["CLIPTextTower", "MDTVTransformer", "PerceiverResampler", "VoltronViT"]
