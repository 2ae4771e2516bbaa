"""Seeded weights, made on the device in a few large draws.

Every Dense weight and bias is uniform in +-1/sqrt(fan_in) (PyTorch's
default initialisation), the depthwise taps uniform with the standard
deviation 1/sqrt(k), every norm's scale 1 + U(-0.1, 0.1) and shift
U(-0.1, 0.1), the BatchNorm running mean U(-0.1, 0.1) and running variance
1 + U(-0.1, 0.1): two draws of one generator on the device, cut into the
leaves. The same seed gives the same weights.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import parameter_shapes


def model_shapes(config: dict) -> list:
    """(name, shape) of every tensor of the configuration's model."""
    a = config["midi_extractor_args"]
    return list(parameter_shapes(dim=a["dim"], lay=a["lay"], indim=config["units_dim"],
                                 outdim=config["midi_num_bins"], kernel_size=a["kernel_size"],
                                 heads=a["attention_heads"], head_dim=a["attention_heads_dim"]))


def _half_width(name: str, shape: tuple, shapes: Dict[str, tuple]) -> float:
    """The leaf's uniform half-width about its centre (0, or 1 for scales)."""
    leaf, kind = name.rsplit(".", 1)
    if leaf.endswith(".dw"):
        k = shape[0] if kind == "weight" else shapes[f"{leaf}.weight"][0]
        return math.sqrt(3.0 / k)
    if f"{leaf}.weight" in shapes and len(shapes[f"{leaf}.weight"]) == 2:
        return 1.0 / math.sqrt(shapes[f"{leaf}.weight"][1])
    return 0.1  # norms: scale, shift, running statistics


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's float32 state dict for ``seed`` on ``device``."""
    shapes = dict(model_shapes(config))
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[pos:pos + n].view(shape) * _half_width(name, shape, shapes)
        if name.endswith("running_var") or (name.endswith(".weight") and len(shape) == 1):
            t += 1.0
        out[name] = t
        pos += n
    return out
