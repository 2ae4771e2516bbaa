"""Binarization CLI: raw DiffSinger dataset -> indexed binary dataset.

Counterpart of the JAX package's ``binarize.py``, with the same flag and
output: ``binary_data_dir`` gets ``{train,valid}.data`` (HDF5, written by
the port's own codec, ``data/hdf5.py``: no h5py) and ``.lengths``, which
``python -m some_tpu_torch.train`` reads.
RMVPE pitch and ContentVec units run on the GPU unless ``--device cpu``;
without a card and without ``--device`` it raises.

    python -m some_tpu_torch.binarize --config configs/continuous.yaml [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib

from some_tpu_torch.config import print_config, read_full_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process the raw dataset into a binary dataset")
    parser.add_argument("--config", required=True, metavar="FILE",
                        help="path to the configuration file")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the networks on the CPU)")
    args = parser.parse_args(argv)

    from some_tpu_torch.inference.base_infer import resolve_device
    from some_tpu_torch.preprocessing import binarizer_class

    device = resolve_device(args.device)
    config = read_full_config(pathlib.Path(args.config))
    print_config(config)
    binarizer = binarizer_class(config["binarizer_cls"])(config, device=str(device))
    print("| Binarizer: ", type(binarizer))
    binarizer.process()


if __name__ == "__main__":
    main()
