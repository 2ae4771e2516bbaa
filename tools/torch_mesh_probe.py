"""Probes of the port's serving mesh on the card (``some_tpu_torch``), one
question a subcommand, each in a fresh process:

    python tools/torch_mesh_probe.py queue graph 4000
    python tools/torch_mesh_probe.py queue eager 2000
    python tools/torch_mesh_probe.py steps [--blocking]
    python tools/torch_mesh_probe.py kernels [--blocking]

``queue KIND N``: how much work CUDA takes behind a spinning exchange before
the host's launch blocks. Replica 0 of a group of two on ``cuda:0`` launches
its exchange (``csrc/replica_max.cu``), which waits on the card for replica
1, and then, from the same thread, N kernels on the same stream: one graph
of N kernel nodes (``graph``) or N eager launches (``eager``). The main
thread gives that thread 3 s, then launches replica 1's exchange from a
third thread. Prints one JSON line: whether replica 0's launches returned
before replica 1's exchange was launched, and whether replica 1's launch
returned while replica 0's thread was still blocked (a launch blocked in one
thread does not stop another thread's).

``steps``: K1-K4 and the backward kernels on ``cuda:0``, then on ``cuda:1``
with device 0 current (chip_smoke's ``kernels_on_second_card``), one wrapper
at a time; after each, both cards are synchronised and PyTorch's current
device is held against CUDA's current context (``cuCtxGetDevice``). Prints a JSON line a
step and stops at the first error. ``--blocking`` sets
``CUDA_LAUNCH_BLOCKING=1`` first, so an error is charged to its launch.
Then the plain versions that the check holds them against, on ``cuda:1``
with device 0 current, one at a time, and the first calls of a two-card
int8 mesh (its streams, its
slot table, one exchange each) with the same checks.

``kernels``: chip_smoke's ``kernels_on_second_card`` as it stands (which
synchronises both cards at its end), ``--blocking`` as above.
"""
from __future__ import annotations

import ctypes
import json
import os
import pathlib
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def queue(kind: str, n: int) -> dict:
    import torch

    from some_tpu_torch.ops.replica_max import ReplicaGroup, replica_stream

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(0)
    group = ReplicaGroup([dev, dev], bound_s=8.0)
    streams = [replica_stream(dev) for _ in group.members]
    amax = torch.ones((), device=dev)
    x = torch.zeros(256, device=dev)
    for member in group.members:
        with member.run_alone():
            member.max(amax)
    x.add_(1)
    graph = None
    if kind == "graph":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=streams[0]):
            for _ in range(n):
                x.add_(1)
    torch.cuda.synchronize()
    got = {"kind": kind, "n": n}

    def replica_0():
        with torch.cuda.stream(streams[0]):
            group.members[0].max(amax)
            t0 = time.perf_counter()
            if graph is not None:
                graph.replay()
            else:
                for _ in range(n):
                    x.add_(1)
            got["replica_0_launch_s"] = time.perf_counter() - t0

    def replica_1():
        with torch.cuda.stream(streams[1]):
            t0 = time.perf_counter()
            group.members[1].max(amax)
            got["replica_1_launch_s"] = time.perf_counter() - t0

    first = threading.Thread(target=replica_0, daemon=True)
    first.start()
    first.join(3.0)
    got["replica_0_returned_alone"] = not first.is_alive()
    second = threading.Thread(target=replica_1, daemon=True)
    second.start()
    second.join(5.0)
    got["replica_1_returned"] = not second.is_alive()
    got["replica_0_blocked_while_1_launched"] = first.is_alive() and got["replica_1_returned"]
    first.join(10.0)
    got["replica_0_returned"] = not first.is_alive()
    torch.cuda.synchronize()
    got["ok"] = True
    return got


def _context_device() -> int:
    """The device of the calling thread's current CUDA context (libcuda)."""
    drv = ctypes.CDLL("libcuda.so.1")
    ctx, device = ctypes.c_void_p(), ctypes.c_int(-1)
    drv.cuCtxGetCurrent(ctypes.byref(ctx))
    drv.cuCtxGetDevice(ctypes.byref(device))
    return device.value


def steps() -> None:
    import torch

    sys.path.insert(0, str(REPO))
    from some_tpu_torch.ops import attention as A
    from some_tpu_torch.ops import depthwise as W
    from some_tpu_torch.ops import fused_ffn as K3

    def check(label):
        state = {"step": label, "torch_device": torch.cuda.current_device(),
                 "context_device": _context_device()}
        failed = False
        for d in (0, 1):
            try:
                torch.cuda.synchronize(d)
                state[f"sync_{d}"] = "ok"
            except Exception as exc:  # noqa: BLE001 - the probe reports what raised
                state[f"sync_{d}"] = str(exc).splitlines()[0]
                failed = True
        print(json.dumps(state), flush=True)
        if failed or state["torch_device"] != state["context_device"]:
            print(json.dumps({"stopped_at": label}), flush=True)
            if failed:
                os._exit(1)

    gen = torch.Generator().manual_seed(11)

    def draw(*shape):
        return torch.randn(*shape, generator=gen)

    B, H, T, D, C = 2, 8, 300, 64, 512
    host = {"x": draw(B, T, C), "w": draw(31, C) / 8, "g": draw(B, T, C),
            "q": draw(B, H, T, D), "k": draw(B, H, T, D), "v": draw(B, H, T, D),
            "do": draw(B, H, T, D), "ffn": draw(B, T, C),
            "ln": [torch.ones(C), torch.zeros(C), draw(C, 4 * C) / C, torch.zeros(4 * C),
                   draw(4 * C, C) / (4 * C), torch.zeros(C)]}
    host_mask = torch.ones(B, T, dtype=torch.bool)
    host_mask[1, 200:] = False
    torch.cuda.set_device(0)
    check("start")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        t = {k: ([x.to(dev) for x in v] if isinstance(v, list) else v.to(dev))
             for k, v in host.items()}
        m = t["mask"] = host_mask.to(dev)
        q, k, v, do = t["q"], t["k"], t["v"], t["do"]
        check(f"{dev} inputs")
        W.depthwise_conv1d(t["x"], t["w"])
        check(f"{dev} k1")
        W.depthwise_conv1d_dx(t["g"], t["w"])
        check(f"{dev} k1_dx")
        W.depthwise_conv1d_dw(t["x"], t["g"], 31)
        check(f"{dev} k1_dw")
        with torch.no_grad():
            A.flash_attention(q, k, v, m, 0.125)
            check(f"{dev} k2")
            K3.fused_ln_ffn_residual(t["ffn"], *t["ln"])
            check(f"{dev} k3")
            A.splash_attention(q, k, v, m, 0.125)
            check(f"{dev} k4")
        o, stats = A.flash_attention_fwd_res(q, k, v, m, 0.125)
        check(f"{dev} k2_fwd_res")
        delta = (do * o).sum(-1).contiguous()
        _, delta2 = A.flash_attention_bwd_dq(q, k, v, do, stats, delta, m, 0.125)
        check(f"{dev} k2_dq")
        A.flash_attention_bwd_dkv(q, k, v, do, stats, delta2, m, 0.125)
        check(f"{dev} k2_dkv")
        o4, lse, _ = A.splash_attention_fwd_res(q, k, v, m)
        check(f"{dev} k4_fwd_res")
        di = A.splash_di(o4, None, do)
        A.splash_attention_bwd_dkv(q, k, v, do, lse, di, m)
        check(f"{dev} k4_dkv")
        A.splash_attention_bwd_dq(q, k, v, do, lse, di, m)
        check(f"{dev} k4_dq")
    # the plain versions on cuda:1 with device 0 current, as the check runs them
    import chip_smoke as S

    plain = [
        ("k1 plain", lambda: W.depthwise_conv1d_plain(t["x"], t["w"])),
        ("k1_dx plain", lambda: W.depthwise_conv1d_plain(t["g"], t["w"].flip(0))),
        ("k1_dw plain", lambda: W.depthwise_conv1d_dw_plain(t["x"], t["g"], 31)),
        ("k2 plain", lambda: S.attention_tolerance(torch, A.attention_plain(q, k, v, m, 0.125))),
        ("k3 plain", lambda: S.fused_ffn_tolerance(
            torch, K3.fused_ln_ffn_residual_plain(t["ffn"], *t["ln"]))),
        ("k4 plain", lambda: S.splash_forward_tolerance(
            torch, A.splash_attention_plain(q, k, v, m, 0.125))),
        ("k2_dq plain", lambda: S.grad_tolerance(torch, A.flash_attention_bwd_dq_plain(
            q, k, v, do, stats, delta, m, 0.125)[0], 0.002)),
        ("k4_dq plain", lambda: S.grad_tolerance(torch, A.splash_attention_bwd_dq_plain(
            q, k, v, do, lse, di, m), 0.002)),
        ("k2_dkv plain", lambda: A.flash_attention_bwd_dkv_plain(q, k, v, do, stats, delta2, m,
                                                                 0.125)),
        ("k4_dkv plain", lambda: A.splash_attention_bwd_dkv_plain(q, k, v, do, lse, di, m)),
    ]
    for label, fn in plain:
        fn()
        check(label)
    torch.cuda.set_device(0)
    check("after the kernels")
    from some_tpu_torch.ops.replica_max import ReplicaGroup, replica_stream

    s0 = torch.cuda.Stream(torch.device("cuda", 0))
    check("a pool stream of cuda:0")
    s1 = torch.cuda.Stream(torch.device("cuda", 1))
    check("a pool stream of cuda:1")
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    group = ReplicaGroup(devices)
    streams = [replica_stream(d) for d in devices]
    check("the group and its streams")
    outs = []
    for member, stream, d in zip(group.members, streams, devices):
        with member.run_alone(), torch.cuda.device(d), torch.cuda.stream(stream):
            outs.append(member.max(torch.full((), 1.0 + d.index, device=d)))
    check("each replica alone")
    outs = []
    for member, stream, d in zip(group.members, streams, devices):
        with torch.cuda.device(d), torch.cuda.stream(stream):
            outs.append(member.max(torch.full((), 1.0 + d.index, device=d)))
    check("one exchange of the two cards")
    print(json.dumps({"maxes": [float(o) for o in outs], "streams": [str(s0), str(s1)]}),
          flush=True)


def main(argv) -> int:
    sys.path.insert(0, str(REPO))
    if len(argv) < 2:
        raise SystemExit(__doc__)
    if argv[1] == "queue":
        print(json.dumps(queue(argv[2], int(argv[3]))), flush=True)
    elif argv[1] == "kernels":
        # chip_smoke's kernels_on_second_card as it stands, then both cards synchronised
        if "--blocking" in argv:
            os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
        import torch

        import chip_smoke

        print(json.dumps(chip_smoke.kernels_on_second_card(torch)), flush=True)
    elif argv[1] == "steps":
        if "--blocking" in argv:
            os.environ["CUDA_LAUNCH_BLOCKING"] = "1"
        steps()
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
