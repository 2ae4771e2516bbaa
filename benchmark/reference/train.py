"""Plain reference of SOME's training step (the continuous model), in float32.

From the task's definition, not from the program: batches padded to the
frame grid (128) and to a power of two of rows; the losses (BCE with logits
against Gaussian note targets over the frames up to the batch's longest
item, plus the running-sum earth mover's distance of the note boundaries);
the gradients by autograd through :class:`MidiExtractorRef` in training
mode (BatchNorm over the real frames, dropout at rate 0.1 with the masks
keyed by (seed, step, site)); the global-norm clip; AdamW (bias-corrected
moments, eps outside the square root) at the warm-up schedule's rate.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.model import MidiExtractorRef


def pad_batch(items: List[dict], grid: int) -> Dict[str, np.ndarray]:
    """Items -> a batch padded to ``grid`` frames and a power of two of rows."""
    b = len(items)
    rows = 1 << (b - 1).bit_length()
    t_real = max(len(it["units"]) for it in items)
    t_pad = -(-t_real // grid) * grid
    note_grid = max(grid // 4, 1)
    n_pad = -(-max(len(it["note_midi"]) for it in items) // note_grid) * note_grid
    out = {"units": np.zeros((rows, t_pad, items[0]["units"].shape[1]), np.float32),
           "unit2note": np.zeros((rows, t_pad), np.int64),
           "note_midi": np.zeros((rows, n_pad), np.float32),
           "note_rest": np.zeros((rows, n_pad), bool),
           "note_mask": np.zeros((rows, n_pad), bool),
           "rows": np.arange(rows) < b, "t_real": t_real}
    for i, it in enumerate(items):
        t, n = len(it["units"]), len(it["note_midi"])
        out["units"][i, :t] = it["units"]
        out["unit2note"][i, :t] = it["unit2note"]
        out["note_midi"][i, :n] = it["note_midi"]
        out["note_rest"][i, :n] = it["note_rest"]
        out["note_mask"][i, :n] = True
    return out


def losses(logits: torch.Tensor, bounds: torch.Tensor, batch: dict, config: dict):
    """(midi loss, boundary loss) of one padded batch (tensors on the device)."""
    u2n = batch["unit2note"]
    rows = batch["rows"].float()
    n_rows = rows.sum().clamp(min=1.0)
    t_pad = u2n.shape[1]
    t_real = float(batch["t_real"])
    frame_w = (torch.arange(t_pad, device=u2n.device) < t_real).float()
    bins = config["midi_num_bins"]
    interval = (config["midi_max"] - config["midi_min"]) / (bins - 1)
    sigma = config["midi_prob_deviation"] / interval
    mu = ((batch["note_midi"] - config["midi_min"]) / interval)[:, :, None]
    x = torch.arange(bins, dtype=torch.float32, device=u2n.device)[None, None, :]
    note_probs = torch.exp(-0.5 * ((x - mu) / sigma) ** 2)
    note_probs = note_probs * (batch["note_mask"] & ~batch["note_rest"])[:, :, None]
    note_probs = torch.cat([torch.zeros_like(note_probs[:, :1]), note_probs], dim=1)
    target = torch.gather(note_probs, 1, u2n[:, :, None].expand(-1, -1, bins))
    z = logits.float()
    bce = torch.clamp(z, min=0) - z * target + torch.log1p(torch.exp(-z.abs()))
    midi = (bce * rows[:, None, None] * frame_w[None, :, None]).sum() / (
        n_rows * max(t_real, 1.0) * bins)
    prev = torch.cat([torch.zeros_like(u2n[:, :1]), u2n[:, :-1]], dim=1)
    starts = ((u2n - prev) > 0).float()
    diff = (torch.cumsum(bounds * frame_w, 1) - torch.cumsum(starts * frame_w, 1)).abs()
    per_row = (diff / math.sqrt(max(t_real, 1.0)) * frame_w).sum(1) / max(t_real, 1.0)
    return midi, (per_row * rows).sum() / n_rows


def warmup_lr(step: int, base: float, warmup: int, floor: float) -> float:
    """The warm-up schedule's rate at ``step`` (updates applied before it)."""
    n = step + 1.0
    lr = base * warmup ** 0.5 * min(n ** -0.5, n * warmup ** -1.5)
    return floor if (lr < floor and n > warmup) else lr


def dropout_masks(seed: int, step: int, rate: float, device):
    """The keep masks of a step, scaled by 1 / (1 - rate): each site's mask
    drawn uniform from a generator on the device keyed by (seed, step, site)."""
    def mask(site: int, shape) -> torch.Tensor:
        key = ((seed * 1_000_003 + step) * 10_007 + site) % (1 << 63)
        gen = torch.Generator(device=device).manual_seed(key)
        keep = torch.rand(shape, generator=gen, device=device) < 1.0 - rate
        return keep.float() / (1.0 - rate)

    return mask


def train_steps(weights: Dict[str, torch.Tensor], batches: List[dict], config: dict,
                seed: int, device, quant=None) -> dict:
    """Run the first ``len(batches)`` steps from ``weights``: {losses: [..],
    grad_norms: {leaf: norm of the first step's clipped gradient},
    changes: {leaf: norm of the parameters' change after the last step}}."""
    a = config["midi_extractor_args"]
    opt = config["optimizer_args"]
    sched = config["lr_scheduler_args"]
    b1, b2 = float(opt.get("beta1", 0.9)), float(opt.get("beta2", 0.999))
    eps, wd = float(opt.get("eps", 1e-8)), float(opt.get("weight_decay", 0.0))
    rate = float(a["ffn_latent_drop"])
    params = {k: v.detach().float().clone().to(device) for k, v in weights.items()
              if not k.endswith(("running_mean", "running_var"))}
    start = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "grad_norms": {}, "changes": {}}
    for step, host in enumerate(batches):
        batch = {k: (torch.from_numpy(x).to(device) if isinstance(x, np.ndarray) else x)
                 for k, x in host.items()}
        leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
        state = dict(leaves, **{k: weights[k].float().to(device) for k in weights
                                if k.endswith(("running_mean", "running_var"))})
        model = MidiExtractorRef(state, a["lay"], a["attention_heads"],
                                 a["attention_heads_dim"], quant=quant)
        mask = batch["unit2note"] > 0
        logits, bounds = model.forward(batch["units"], mask, train=True,
                                       dropout=dropout_masks(seed, step, rate, device))
        midi, bound = losses(logits, bounds, batch, config)
        total = midi + bound
        names = list(leaves)
        grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k]))
                 for k, g in zip(names, grads)}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        clip = float(config.get("clip_grad_norm") or 0)
        if clip > 0 and float(norm) >= clip:
            grads = {k: g * (clip / norm) for k, g in grads.items()}
        if step == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
        lr = warmup_lr(step, float(opt["lr"]), int(sched.get("warmup_steps", 0)),
                       float(sched.get("min_lr", 0.0)))
        t = step + 1
        with torch.no_grad():
            for k, g in grads.items():
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt() + eps
                params[k].mul_(1 - lr * wd).sub_(lr / (1 - b1 ** t) * m[k] / denom)
        out["losses"].append(float(total.detach()))
    out["changes"] = {k: float((params[k] - start[k]).norm()) for k in params}
    return out
