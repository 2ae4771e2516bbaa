"""Weights from the JAX package's layout into the port's modules.

The JAX package keeps a model's weights as a flax variable tree:
``params`` (Dense ``kernel [in, out]`` + ``bias``, LayerNorm / BatchNorm
``scale`` + ``bias``, the depthwise ``kernel [k, C]``) and ``batch_stats``
(BatchNorm ``mean`` / ``var``). The port names its modules after that tree,
so the mapping is per leaf:

  * ``.../kernel [in, out]`` -> ``....weight [out, in]`` (transposed), except
    the depthwise ``.../dw/kernel [k, C]``, which keeps its layout;
  * ``scale`` -> ``weight``; ``bias`` -> ``bias``;
  * batch_stats ``mean`` / ``var`` -> the ``running_mean`` / ``running_var``
    buffers;
  * an int8 serving model's ``qscales`` collection: ``.../kernel_scale`` ->
    ``....weight_scale``; its int8 kernels transpose and stay int8 (the
    buffers ``ops/quant.py`` gives a quantized ``QDense``).

Trees are nested dicts of numpy arrays (what the native checkpoint holds);
nothing here imports JAX. :func:`optax_state_to_torch` carries the optax
optimizer state of a JAX training checkpoint into the torch optimizer, so a
JAX run resumes in the port. The native SOME-TPU checkpoint is msgpack, read
with ``msgpack`` imported inside :func:`read_native_checkpoint` only.
"""
from __future__ import annotations

import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_QSCALE_LEAVES = {"kernel_scale": "weight_scale"}


def _flatten(tree: dict, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, dict):
            out.update(_flatten(sub, path))
        else:
            out[path] = np.asarray(sub)
    return out


def jax_params_to_state_dict(params: dict, batch_stats: Optional[dict] = None,
                             qscales: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """flax ``params`` / ``batch_stats`` / ``qscales`` trees -> the port's
    ``state_dict``: float32, except int8 kernels, which stay int8.

    Raises ``KeyError`` on a leaf no rule maps. Use :func:`load_jax_variables`
    to also fail on a port parameter the trees leave unfilled."""
    state = {}
    for collection, rules, tree in (("params", _PARAM_LEAVES, params),
                                    ("batch_stats", _STAT_LEAVES, batch_stats or {}),
                                    ("qscales", _QSCALE_LEAVES, qscales or {})):
        for path, leaf in _flatten(tree).items():
            if path[-1] not in rules:
                raise KeyError(f"unmapped {collection} leaf {'/'.join(path)}")
            key = ".".join(path[:-1] + (rules[path[-1]],))
            if path[-1] == "kernel" and path[-2] != "dw":
                if leaf.ndim != 2:
                    raise KeyError(f"kernel {'/'.join(path)} is not 2-D: {leaf.shape}")
                leaf = leaf.T
            if key in state:
                raise KeyError(f"two leaves map onto {key}")
            dtype = np.int8 if leaf.dtype == np.int8 and path[-1] == "kernel" else np.float32
            state[key] = torch.from_numpy(np.array(leaf, dtype=dtype, order="C"))
    return state


def load_jax_variables(model: nn.Module, params: dict,
                       batch_stats: Optional[dict] = None, qscales: Optional[dict] = None) -> None:
    """Fill ``model`` from flax trees; raises on any leaf left unmapped and on
    any port parameter or buffer left unfilled (or of the wrong shape). Int8
    kernels (with their ``qscales``) turn their modules into int8 ones."""
    state = jax_params_to_state_dict(params, batch_stats, qscales)
    if qscales:
        from some_tpu_torch.ops.quant import adopt_int8_layout

        adopt_int8_layout(model, state)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError(f"weights do not match the model: unfilled {missing}, "
                       f"unmapped {unexpected}")


def jax_variable_shapes(model: nn.Module) -> Dict[str, dict]:
    """The flax variable tree (as shapes) that :func:`jax_params_to_state_dict`
    maps onto ``model`` — the inverse of its rules (with ``qscales`` for a
    quantized model)."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    inverse = {"running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var"),
               "weight_scale": ("qscales", "kernel_scale")}
    for key, tensor in model.state_dict().items():
        *path, name = key.split(".")
        shape = tuple(tensor.shape)
        if name in inverse:
            collection, leaf = inverse[name]
            trees.setdefault(collection, {})
        elif name == "bias":
            collection, leaf = "params", "bias"
        elif tensor.dim() == 2:
            collection, leaf = "params", "kernel"
            if path[-1] != "dw":
                shape = shape[::-1]
        else:
            collection, leaf = "params", "scale"
        node = trees[collection]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = shape
    return trees


def random_jax_variables(model: nn.Module, seed: int) -> Dict[str, dict]:
    """Weights for ``model`` drawn with numpy from ``seed`` in the flax
    layout: kernels and biases uniform in +-1/sqrt(fan_in) (PyTorch's default
    scale), norm scales 1 and biases 0, BatchNorm running mean N(0, 0.5) and
    variance U(0.5, 2) so the stats are exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax_variable_shapes(model)

    def draw(tree: dict, collection: str) -> dict:
        out = {}
        fan_in = tree["kernel"][0] if "kernel" in tree else None
        for name, sub in tree.items():
            if isinstance(sub, dict):
                out[name] = draw(sub, collection)
            elif collection == "batch_stats":
                out[name] = (rng.normal(0, 0.5, sub) if name == "mean"
                             else rng.uniform(0.5, 2.0, sub)).astype(np.float32)
            elif fan_in is None:  # LayerNorm / BatchNorm affine
                out[name] = (np.ones(sub) if name == "scale" else np.zeros(sub)).astype(np.float32)
            else:
                bound = 1.0 / np.sqrt(fan_in)
                out[name] = rng.uniform(-bound, bound, sub).astype(np.float32)
        return out

    return {c: draw(shapes[c], c) for c in ("params", "batch_stats")}


def read_native_checkpoint(path: pathlib.Path | str) -> dict:
    """A native SOME-TPU checkpoint (flax msgpack: {meta, params,
    batch_stats, opt_state}) as nested dicts of numpy arrays."""
    import msgpack

    def ext_hook(code, data):
        if code in (1, 3):  # flax ndarray / numpy scalar: (shape, dtype, bytes)
            shape, dtype, buffer = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buffer, dtype=np.dtype(dtype.decode())).reshape(shape)
            return arr if code == 1 else arr[()]
        raise ValueError(f"{path}: unsupported msgpack extension type {code}")

    payload = msgpack.unpackb(pathlib.Path(path).read_bytes(), ext_hook=ext_hook, raw=False)

    def check(tree):
        if isinstance(tree, dict):
            if "__msgpack_chunked_array__" in tree:
                raise ValueError(f"{path}: chunked arrays (> 1 GiB) are not supported")
            for sub in tree.values():
                check(sub)
    check(payload)
    return payload


def _find(tree, keys):
    """The first dict in ``tree`` (depth first) that holds every key of ``keys``."""
    if not isinstance(tree, dict):
        return None
    if all(k in tree for k in keys):
        return tree
    for sub in tree.values():
        found = _find(sub, keys)
        if found is not None:
            return found
    return None


def optax_state_to_torch(opt_state: dict, model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> Tuple[dict, Optional[dict]]:
    """An optax state, as a native checkpoint holds it, -> (a state_dict for
    ``optimizer``, the gradient accumulator or None).

    The state is the JAX package's chain: ``clip_by_global_norm`` (no state),
    ``scale_by_adam`` (``count``, ``mu``, ``nu``), the decoupled decay and the
    schedule (its count equals Adam's), possibly inside ``optax.MultiSteps``
    (``mini_step``, ``acc_grads``, ``inner_opt_state``). ``mu`` and ``nu`` map
    leaf by leaf like the weights (kernels transposed) onto each parameter's
    ``exp_avg`` and ``exp_avg_sq``, ``count`` onto its ``step``; a
    part-filled accumulation (``mini_step > 0``) comes back as
    ``{"mini_step", "grads"}``, the running mean optax keeps."""
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise KeyError("no scale_by_adam state (count, mu, nu) in the optax state")
    mu = jax_params_to_state_dict(adam["mu"])
    nu = jax_params_to_state_dict(adam["nu"])
    count = float(np.asarray(adam["count"]))
    names = {p: n for n, p in model.named_parameters()}
    sd = optimizer.state_dict()
    flat = [p for group in optimizer.param_groups for p in group["params"]]
    sd["state"] = {i: {"step": torch.tensor(count), "exp_avg": mu[names[p]],
                       "exp_avg_sq": nu[names[p]]} for i, p in enumerate(flat)}
    multi = _find(opt_state, ("mini_step", "acc_grads"))
    accumulator = None
    if multi is not None and int(np.asarray(multi["mini_step"])) > 0:
        accumulator = {"mini_step": int(np.asarray(multi["mini_step"])),
                       "grads": jax_params_to_state_dict(multi["acc_grads"])}
    return sd, accumulator
