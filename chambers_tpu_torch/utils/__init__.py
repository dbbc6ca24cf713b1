"""Utilities of the port (``chambers_tpu/utils``): parameter paths
(``pytree``), tensor and ranking helpers, profiling, the generic helpers,
TensorBoard event files and Flax's msgpack weight files.

``data`` (pairwise batch prediction over ``chambers_tpu.data`` datasets)
comes with the host data pipeline, ROADMAP.md §1 item 7.
"""
