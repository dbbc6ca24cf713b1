"""Dataset snapshot save/load (port of ``chambers_tpu/data/persist.py``;
both packages read each other's snapshots).

``save_dataset`` snapshots a dataset to sharded record files with a JSON
``dataset.metadata`` element-spec sidecar, sharding by ``enumerate() %
n_files``; ``load_dataset`` restores it.
"""

import json
import os

from chambers_tpu_torch.data.core import Dataset
from chambers_tpu_torch.data.records import (
    deserialize_element,
    element_spec,
    serialize_element,
)

_METADATA_FILE = "dataset.metadata"


def save_dataset(dataset, path: str, n_files: int = 1):
    """Snapshot ``dataset`` into ``n_files`` shards under ``path``."""
    os.makedirs(path, exist_ok=True)
    shards = [
        open(os.path.join(path, f"shard-{i:05d}.records"), "wb")
        for i in range(n_files)
    ]
    spec = None
    try:
        for i, element in enumerate(dataset):
            if spec is None:
                spec = element_spec(element, set_shape=True)
            shards[i % n_files].write(serialize_element(element))
    finally:
        for f in shards:
            f.close()

    with open(os.path.join(path, _METADATA_FILE), "w") as f:
        json.dump({"element_spec": _spec_to_json(spec), "n_files": n_files}, f)


def load_dataset(path: str) -> Dataset:
    """Restore a dataset snapshot; elements interleave across shards in the
    original round-robin order, so iteration order round-trips."""
    with open(os.path.join(path, _METADATA_FILE)) as f:
        metadata = json.load(f)
    n_files = metadata["n_files"]
    shard_paths = [
        os.path.join(path, f"shard-{i:05d}.records") for i in range(n_files)
    ]

    def gen():
        handles = [open(p, "rb") for p in shard_paths]
        try:
            while True:
                alive = False
                for f in handles:
                    element = deserialize_element(f)
                    if element is not None:
                        alive = True
                        yield element
                if not alive:
                    return
        finally:
            for f in handles:
                f.close()

    ds = Dataset(gen)
    ds.element_spec = _spec_from_json(metadata["element_spec"])
    return ds


def _spec_to_json(spec):
    if spec is None:
        return None
    return [
        {"shape": list(shape) if shape is not None else None, "dtype": dtype}
        for shape, dtype in spec
    ]


def _spec_from_json(data):
    if data is None:
        return None
    return tuple(
        (tuple(d["shape"]) if d["shape"] is not None else None, d["dtype"])
        for d in data
    )
