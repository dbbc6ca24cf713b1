"""The host data pipeline (port of ``chambers_tpu/data``): the same names,
the same element streams for the same seeds, and files either package reads."""

from chambers_tpu_torch.data.core import Dataset
from chambers_tpu_torch.data.dataset import (
    InterleaveImageClassDataset,
    InterleaveImageClassTripletDataset,
    InterleaveImageTripletDataset,
    SequentialImageDataset,
    set_n_parallel,
)
from chambers_tpu_torch.data.io import (
    match_img_files,
    match_img_files_triplet,
    match_nested_set,
    read_and_decode_image,
    read_and_decode_images,
    url_to_img,
    validate_dir_path,
)
from chambers_tpu_torch.data.records import dataset_to_records, records_to_dataset
from chambers_tpu_torch.data.tfrecord import (
    dataset_to_tfrecord,
    make_dataset_deserialize_fn,
    serialize_to_example,
    tfrecord_to_dataset,
)
from chambers_tpu_torch.data.persist import load_dataset, save_dataset
from chambers_tpu_torch.data.loader import device_prefetch
