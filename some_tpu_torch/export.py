"""Export CLI: checkpoint -> deployment artifact.

Counterpart of the JAX package's ``export.py``, in two formats (reference
counterpart: export.py:52-106):

  * ``pt2`` (the default; the JAX CLI's ``stablehlo``): one ``torch.export``
    program per frame bucket plus a manifest (``deployment/export.py``),
    which runs the hand-written kernels as ``torch.library`` ops; load it
    with ``some_tpu_torch.deployment.export.load_exported``. ``--device``
    (the JAX CLI's ``--platforms``) is the device it is traced on and runs
    on: ``cuda`` unless ``--device cpu``.
  * ``onnx``: the reference's opset-17 waveform -> notes graph for the
    DiffSinger tools, through the first-party torch model
    (``deployment/onnx_export.py``). It is traced on the CPU whatever
    ``--device`` says, since the graph names no device.

The checkpoint is the port's own, a native SOME-TPU one or a reference
Lightning ``.ckpt``, with its ``config.yaml`` beside it, as for ``infer``.

    python -m some_tpu_torch.export --model CKPT [--out PATH] [--format pt2|onnx]
        [--buckets 256,512,1024,2048,4096] [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib

from some_tpu_torch.config import load_yaml, print_config
from some_tpu_torch.utils.checkpoint import load_state_dict


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Export a trained model as a deployment "
                                                 "artifact")
    parser.add_argument("--model", required=True, metavar="CKPT_PATH",
                        help="path to the model checkpoint")
    parser.add_argument("--out", metavar="OUT_PATH",
                        help="output path (default: <ckpt>.pt2/ or <ckpt>.onnx)")
    parser.add_argument("--format", dest="fmt", choices=("pt2", "onnx"), default="pt2",
                        help="artifact format: pt2 (a torch.export program per bucket) or "
                             "onnx (traced on the CPU, always)")
    parser.add_argument("--buckets", default="256,512,1024,2048,4096",
                        help="comma-separated frame buckets to export (pt2)")
    parser.add_argument("--device", default=None,
                        help="device the pt2 programs are traced on and run on (default "
                             "cuda); onnx ignores it")
    args = parser.parse_args(argv)

    model_path = pathlib.Path(args.model)
    config = load_yaml(model_path.with_name("config.yaml"))
    print_config(config)

    if args.fmt == "onnx":
        from some_tpu_torch.deployment.onnx_export import export_onnx

        out_path = pathlib.Path(args.out) if args.out else model_path.with_suffix(".onnx")
        export_onnx(config, load_state_dict(model_path), out_path)
        print(f"ONNX model saved at: '{out_path}'")
        return

    from some_tpu_torch.deployment.export import TASK_DEPLOYMENT_MAPPING

    exporter_cls = TASK_DEPLOYMENT_MAPPING.get(config["task_cls"])
    if exporter_cls is None:
        raise KeyError(f"no exporter registered for task {config['task_cls']!r}")
    exporter = exporter_cls(config=config, model_path=model_path, device=args.device)
    out_dir = pathlib.Path(args.out) if args.out else model_path.with_suffix(".pt2")
    exporter.export(out_dir, buckets=[int(b) for b in args.buckets.split(",") if b.strip()])
    print(f"torch.export artifact saved at: '{out_dir}'")


if __name__ == "__main__":
    main()
