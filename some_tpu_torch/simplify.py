"""Strip a checkpoint to inference-only weights.

Counterpart of the JAX package's ``simplify.py`` (reference: simplify.py:7-21).
The input is the port's own checkpoint, a native SOME-TPU one or a reference
Lightning ``.ckpt``; the output is always the port's, with no optimizer
state (``utils/checkpoint.simplify_checkpoint``).

    python -m some_tpu_torch.simplify INPUT_CKPT OUTPUT_CKPT
"""
from __future__ import annotations

import argparse

from some_tpu_torch.utils.checkpoint import simplify_checkpoint


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Simplify a checkpoint, dropping all keys useless for inference.")
    parser.add_argument("input_ckpt", metavar="INPUT_CKPT")
    parser.add_argument("output_ckpt", metavar="OUTPUT_CKPT")
    args = parser.parse_args(argv)
    simplify_checkpoint(args.input_ckpt, args.output_ckpt)
    print(f"| saved simplified checkpoint to '{args.output_ckpt}'")


if __name__ == "__main__":
    main()
