"""Pairwise batch prediction over datasets (``chambers_tpu/utils/data.py``)
is not ported yet: it is built on ``chambers_tpu.data``'s ``Dataset``,
which comes with the host data pipeline, ROADMAP.md §1 item 7. Every name
raises an ``AttributeError`` that says so."""

_NAMES = ("valid_cardinality", "pair_iteration_dataset",
          "reshape_pair_predictions", "batch_predict_pairs")


def __getattr__(name):
    raise AttributeError(
        f"chambers_tpu_torch.utils.data.{name} is not ported yet: it needs "
        "the host data pipeline's Dataset (ROADMAP.md §1 item 7)")
