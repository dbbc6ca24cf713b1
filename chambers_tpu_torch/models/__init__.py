"""Models of the port and generation over them."""

from chambers_tpu_torch.models.generation import (
    QuantizedDecodeWarning,
    apply_top_k_top_p,
    beam_search_decode,
    greedy_decode,
    sample_decode,
)
from chambers_tpu_torch.models.model import Model
from chambers_tpu_torch.models.transformer import Seq2SeqTransformer

__all__ = [
    "Model",
    "QuantizedDecodeWarning",
    "Seq2SeqTransformer",
    "apply_top_k_top_p",
    "beam_search_decode",
    "greedy_decode",
    "sample_decode",
]
