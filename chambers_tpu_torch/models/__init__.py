"""Models of the port."""

from chambers_tpu_torch.models.transformer import Seq2SeqTransformer

__all__ = ["Seq2SeqTransformer"]
