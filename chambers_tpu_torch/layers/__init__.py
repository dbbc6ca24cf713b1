"""Layers: attention, the transformer stacks, embeddings, norms, distances,
pooling, descriptors and the mixture-of-experts layers. The same names as
``chambers_tpu/layers/__init__.py``, ``ops`` included."""

from chambers_tpu_torch.layers.attention import (
    MultiHeadAttention,
    ScaledAttention,
    scaled_attention,
    scaled_dot_product_attention,
)
from chambers_tpu_torch.layers.transformer import (
    Decoder,
    DecoderLayer,
    Encoder,
    EncoderLayer,
)
from chambers_tpu_torch.layers.embedding import (
    ConcatEmbedding,
    LearnedEmbedding0D,
    LearnedEmbedding1D,
    PositionalEncoding1D,
    PositionalEncoding2D,
    angle_rates,
    positional_encoding_1d,
    positional_encoding_2d,
    sequence_sin_cos_angles,
)
from chambers_tpu_torch.layers.normalization import (
    L2Normalization,
    l2_normalize,
)
from chambers_tpu_torch.layers.distance import (
    AngularCosineSimilarity,
    CosineSimilarity,
    CubicCosineSimilarity,
    L1Distance,
    L2Distance,
    SqrtCosineSimilarity,
)
from chambers_tpu_torch.layers.pooling import (
    GlobalGeneralizedMean,
    RoiPooling,
    RoiPooling_OG,
    roi_max_pool,
    spatial_pyramid_roi_pool,
)
from chambers_tpu_torch.layers.descriptors import RMAC, rmac_regions
from chambers_tpu_torch.layers.moe import (
    MoEDecoderLayer,
    MoEEncoderLayer,
    MoEMLP,
    moe_aux_loss,
)
from chambers_tpu_torch.layers import ops
