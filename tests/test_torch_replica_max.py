"""The cross-replica max of int8 serving on a mesh (``ops/replica_max.py``),
on the CPU: the plain exchange over N threads, the int8 sites of a
production-depth forward (8 dual-stream layers at a narrow width), the paths
that make no exchange, and a replica run alone.

The kernel itself runs only on the card (tests/test_torch_mesh_gpu.py,
chip_smoke.py's ``check_replica_max`` and ``mesh`` phase).
"""
import threading
import time

import numpy as np
import pytest
import torch

from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.nn.conformer import QDense, SelfAttention
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.ops.quant import quantize_activation
from some_tpu_torch.ops.replica_max import (
    PeerError, ReplicaGroup, replica_max, replica_max_plain,
)
from some_tpu_torch.parallel.mesh import make_mesh, pad_rows
from tests.test_inference import TINY_MODEL_CONFIG, synth

LAYERS = 8  # the production depth: 18 conformer blocks, 160 int8 sites a forward
CONFIG = dict(TINY_MODEL_CONFIG, transfer_dtype="float32",
              midi_extractor_args=dict(TINY_MODEL_CONFIG["midi_extractor_args"], lay=LAYERS))
SITES = 8 * (2 * LAYERS + 2) + 2 * LAYERS
WAVS = [synth(1.0, 440, seed=1), synth(1.3, 523, seed=2), synth(0.8, 330, seed=3)]


def within(seconds, fn):
    """``fn()`` in a daemon thread, which must end within ``seconds``: (its
    result, or the exception it raised)."""
    box = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as exc:  # noqa: BLE001 - handed back to the test
            box["error"] = exc

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(seconds)
    assert not thread.is_alive(), f"still running after {seconds} s"
    return box


@pytest.fixture(scope="module")
def state():
    variables = random_jax_variables(build_midi_extractor(CONFIG), seed=5)
    return jax_params_to_state_dict(variables["params"], variables["batch_stats"])


def engine(state, n=None, **overrides):
    kwargs = {"device": "cpu"} if n is None else {"mesh": make_mesh(["cpu"] * n)}
    return MIDIExtractionInference.from_state_dict(dict(CONFIG, **overrides), state,
                                                   dtype=torch.float32, **kwargs)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_plain_exchange_gives_every_replica_the_max(n):
    """N threads, 40 exchanges each: every replica gets the max of the N
    amaxes, bit for bit the same tensor values, ``replica_max_plain``'s;
    all zeros give 0, and the int8 scale is then the 1e-8 clamp."""
    group = ReplicaGroup(["cpu"] * n)
    rng = np.random.default_rng(n)
    draws = rng.exponential(3.0, size=(40, n)).astype(np.float32)
    draws[7] = 0.0
    got = group.run_threads([
        lambda r=r: [replica_max(torch.tensor(draws[i, r]), group.members[r])
                     for i in range(len(draws))] for r in range(n)])
    for i in range(len(draws)):
        want = replica_max_plain([torch.tensor(v) for v in draws[i]])
        assert float(want) == draws[i].max()
        for r in range(n):
            assert torch.equal(got[r][i], want)
    zeros = group.run_threads([
        lambda r=r: quantize_activation(torch.zeros(3, 4), group.members[r])[1]
        for r in range(n)])
    assert all(float(sx) == np.float32(1e-8) for sx in zeros)
    assert replica_max.launches == 0  # the plain version launches nothing


def test_int8_sites_share_one_scale_across_replicas(state):
    """One int8 bucket on a mesh of 2: every replica meets its peer at
    every int8 site, 160 a forward at the production depth, and takes the
    same max there, bit for bit; it is the whole padded bucket's, as a
    one-device int8 engine's run of the bucket computes it."""
    mesh, solo = engine(state, 2, quantize="int8"), engine(state, quantize="int8")
    seen = {}
    for replica in (*mesh.replicas, solo):
        sites = seen[id(replica)] = []
        for module in replica.model.modules():
            if isinstance(module, (QDense, SelfAttention)):
                member = module.replica
                assert (member is None) == (replica is solo)
        if replica is solo:
            continue
        member = replica._member
        exchange = member.max

        def recording(amax, exchange=exchange, sites=sites):
            out = exchange(amax)
            sites.append(out)
            return out

        member.max = recording
    groups, _ = solo.bucket_groups(WAVS)
    (_, audio, mask), = groups
    mesh.run_bucket(audio, mask)
    got = [torch.stack(seen[id(r)]) for r in mesh.replicas]
    assert len(got[0]) == len(got[1]) == SITES == 160
    assert torch.equal(got[0], got[1])
    sx = [torch.clamp(g / 127.0, min=1e-8) for g in got]
    assert torch.equal(sx[0], sx[1]) and (sx[0] > 1e-8).all()

    # the one-device engine on the whole padded bucket: the same amax at every site
    # (the int8 q/kv projections run inside SelfAttention, which quantizes its input once)
    whole = []
    for module in solo.model.modules():
        if (isinstance(module, QDense) and module.is_int8) or isinstance(module, SelfAttention):
            module.register_forward_pre_hook(lambda m, args: whole.append(
                args[0].float().abs().amax()))
    solo.run_bucket(*pad_rows(audio, mask, 2, mesh.wire, mask.shape[1] * mesh.hop - 1))
    assert torch.equal(torch.stack(whole), got[0])


def test_no_exchange_without_an_int8_mesh(state, monkeypatch):
    """A non-int8 mesh and a lone int8 engine have no group and never call
    the exchange."""
    calls = []
    monkeypatch.setattr(ReplicaGroup, "_meet", lambda self, rank, amax: calls.append(rank))
    f32_mesh = engine(state, 2)
    assert all(r._member is None for r in f32_mesh.replicas)
    f32_mesh.infer(WAVS)
    lone = engine(state, quantize="int8")
    assert lone._member is None and len(lone.replicas) == 1
    lone.infer(WAVS)
    assert calls == []


def test_a_replica_alone_raises_and_does_not_hang(state):
    """``_run`` of one replica of an int8 mesh is refused at once; under
    ``alone()`` it runs against a group of one (its own shard's scale, the
    one-device engine's run of that shard); an exchange that meets no peer
    raises within its bound; a failure in one replica's thread breaks the
    barrier for the others at once, and the group serves the next round."""
    mesh, solo = engine(state, 2, quantize="int8"), engine(state, quantize="int8")
    groups, _ = solo.bucket_groups(WAVS)
    (_, audio, mask), = groups
    a, m, _ = mesh.replicas[1]._stage(audio[:2], mask[:2])
    box = within(10, lambda: mesh.replicas[1]._run(a, m, None, False, False))
    assert isinstance(box.get("error"), RuntimeError) and "alone()" in str(box["error"])
    with mesh.replicas[1].alone():
        got = within(30, lambda: mesh.replicas[1]._run(a, m, None, False, False))["result"]
    want = solo.run_bucket(audio[:2], mask[:2])
    assert all(torch.equal(got[k], want[k]) for k in want)

    group = ReplicaGroup(["cpu"] * 2, bound_s=0.5)
    t0 = time.perf_counter()
    box = within(10, lambda: replica_max(torch.tensor(1.0), group.members[0]))
    assert isinstance(box.get("error"), PeerError)
    assert time.perf_counter() - t0 < 5

    group = ReplicaGroup(["cpu"] * 2)  # the default bound: the abort must not wait for it

    def fails():
        raise ValueError("a replica's forward failed")

    t0 = time.perf_counter()
    box = within(30, lambda: group.run_threads(
        [lambda: replica_max(torch.tensor(2.0), group.members[0]), fails]))
    assert isinstance(box.get("error"), ValueError) and time.perf_counter() - t0 < 10
    got = group.run_threads([lambda r=r: replica_max(torch.tensor(float(r)), group.members[r])
                             for r in range(2)])
    assert [float(g) for g in got] == [1.0, 1.0]
    # the mesh still serves after the refused and the lone runs
    assert torch.equal(mesh.run_bucket(audio, mask)["n_notes"][:3],
                       solo.run_bucket(*pad_rows(audio, mask, 2, mesh.wire,
                                                 mask.shape[1] * mesh.hop - 1))["n_notes"][:3])
