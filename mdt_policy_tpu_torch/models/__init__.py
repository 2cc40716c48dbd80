"""Networks of the port."""

from .blocks import (
    AdaLNZero,
    Attention,
    BiaslessLayerNorm,
    Block,
    ClipStyleProjection,
    ConditionedBlock,
    CrossAttentionOnlyBlock,
    MAPAttention,
    MAPBlock,
    MeanPooling,
    MLP,
    NoiseBlock,
    RMSNorm,
    SiamneseDecoder,
    SigmaEmbedding,
    SinusoidalPosEmb,
    SwishGLU,
    TransformerCrossAttentionEncoder,
    TransformerCrossAttentionOnlyEncoder,
    TransformerDecoder,
    TransformerEncoder,
    TransformerEncoderInterleaved,
    TransformerFiLMDecoder,
    TransformerFiLMDecoderInterleaved,
    TransformerFiLMEncoder,
    modulate,
)
from .clip import CLIPResNetTower, CLIPTextTower, CLIPVisionTower, clip_normalize
from .encoders_misc import (
    CLIPVisionTokens,
    FourierFeatures,
    GaussianFourierEmbedding,
    NoEncoder,
    SinusoidalTimeEmbedding,
    VisionClipHead,
    VoltronMAPEncoder,
)
from .masked_decoder import MaskedTransformerImgDecoder
from .mdt_transformer import MDTTransformer
from .mdtv_transformer import MDTVTransformer
from .perceiver import PerceiverResampler
from .position_embeddings import DynamicPositionBias, RelativePositionBias, RotaryEmbedding
from .resnet import BesoResNetEncoder, ResNet18GN, SpatialSoftmax
from .voltron_vit import VoltronBlock, VoltronViT

__all__ = [
    "AdaLNZero", "Attention", "BesoResNetEncoder", "BiaslessLayerNorm", "Block",
    "ClipStyleProjection", "CLIPResNetTower", "CLIPTextTower", "CLIPVisionTokens",
    "CLIPVisionTower", "ConditionedBlock", "CrossAttentionOnlyBlock", "DynamicPositionBias",
    "FourierFeatures", "GaussianFourierEmbedding", "MAPAttention", "MAPBlock",
    "MaskedTransformerImgDecoder", "MDTTransformer", "MDTVTransformer", "MeanPooling", "MLP",
    "NoEncoder", "NoiseBlock", "PerceiverResampler", "RelativePositionBias", "ResNet18GN",
    "RMSNorm", "RotaryEmbedding", "SiamneseDecoder", "SigmaEmbedding",
    "SinusoidalPosEmb", "SinusoidalTimeEmbedding", "SpatialSoftmax", "SwishGLU",
    "TransformerCrossAttentionEncoder", "TransformerCrossAttentionOnlyEncoder",
    "TransformerDecoder", "TransformerEncoder", "TransformerEncoderInterleaved",
    "TransformerFiLMDecoder", "TransformerFiLMDecoderInterleaved", "TransformerFiLMEncoder",
    "VisionClipHead", "VoltronBlock", "VoltronMAPEncoder", "VoltronViT", "clip_normalize",
    "modulate",
]
