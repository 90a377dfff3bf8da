"""Which process-group backend carries two ranks on one CUDA device.

    python3 scripts/probe_two_ranks_one_card.py            # on a GPU machine
    python3 scripts/probe_two_ranks_one_card.py --device cpu   # rehearsal

For each backend (``nccl``, ``gloo``) the script starts two ranks in child
processes, both on ``cuda:0`` (or the CPU), joined through a ``file://``
store, and runs each collective that DTensor's placements need on a tensor
of that device: ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``broadcast``, then DTensor step by step: a
``(1, 2)`` ``DeviceMesh``, ``distribute_tensor`` of each rank's own
copy, a column-then-row sharded product, its ``redistribute`` to
``Replicate`` and a ``full_tensor()``.  Each op's result
is checked against the value one process computes, and each rank prints
one JSON line ``{op: "ok" | "<error>"}`` as each op ends (so a rank that
dies shows the last op it finished); the parent prints each rank's lines
and exit code, then the card's name and power limit.  A child that hangs
is killed at its time limit, which is printed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

def _first_line(e: BaseException) -> str:
    text = str(e).strip().splitlines()
    return f"{type(e).__name__}: {text[0] if text else ''}"[:300]


def child(backend: str, rank: int, store: str, device: str) -> None:
    import torch
    import torch.distributed as dist
    out = {}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=2)
        out["init"] = "ok"
    except Exception as e:       # the probe reports each failure and goes on
        out["init"] = _first_line(e)
        print(json.dumps({"backend": backend, "rank": rank, **out}))
        return

    def run(name, fn):
        print(json.dumps({"backend": backend, "rank": rank,
                          "starting": name}), flush=True)
        try:
            out[name] = "ok" if fn() else "wrong value"
        except Exception as e:
            out[name] = _first_line(e)
        print(json.dumps({"backend": backend, "rank": rank,
                          name: out[name]}), flush=True)

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return bool((x == 3).all())

    def all_gather():
        x = torch.full((2,), float(rank), device=dev)
        y = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y.tolist() == [0.0, 0.0, 1.0, 1.0]

    def reduce_scatter():
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        y = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(y, x)
        want = [1.0, 3.0] if rank == 0 else [5.0, 7.0]
        return y.tolist() == want

    def broadcast():
        x = torch.full((3,), float(7 if rank == 0 else -1), device=dev)
        dist.broadcast(x, 0)
        return bool((x == 7).all())

    st = {}

    def mesh():
        from torch.distributed.device_mesh import DeviceMesh
        st["mesh"] = DeviceMesh(dev.type, torch.arange(2).reshape(1, 2),
                                mesh_dim_names=("data", "model"))
        return True

    def place():
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        g = torch.Generator(dev).manual_seed(0)
        x = torch.randn(8, 16, device=dev, generator=g)
        w1 = torch.randn(16, 32, device=dev, generator=g)
        w2 = torch.randn(32, 16, device=dev, generator=g)
        st["want"], st["w1"] = torch.relu(x @ w1) @ w2, w1
        m = st["mesh"]
        st["x"] = distribute_tensor(x, m, (Replicate(), Replicate()),
                                    src_data_rank=None)
        st["d1"] = distribute_tensor(w1, m, (Replicate(), Shard(1)),
                                     src_data_rank=None)
        st["d2"] = distribute_tensor(w2, m, (Replicate(), Shard(0)),
                                     src_data_rank=None)
        return True

    def product():
        st["partial"] = torch.relu(st["x"] @ st["d1"]) @ st["d2"]
        return st["partial"].placements[1].is_partial()

    def redistribute():
        from torch.distributed.tensor import Replicate
        got = st["partial"].redistribute(st["mesh"],
                                         (Replicate(), Replicate()))
        return bool(torch.allclose(got.to_local(), st["want"], rtol=1e-4,
                                   atol=1e-4))

    def full_tensor():
        return bool(torch.equal(st["d1"].full_tensor(), st["w1"]))

    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("broadcast", broadcast), ("dtensor_mesh", mesh),
                     ("dtensor_place", place), ("dtensor_product", product),
                     ("dtensor_redistribute", redistribute),
                     ("dtensor_full_tensor", full_tensor)):
        run(name, fn)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({"backend": backend, "rank": rank, "done": out}),
          flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--child", nargs=3, metavar=("BACKEND", "RANK", "STORE"))
    args = ap.parse_args()
    if args.child:
        child(args.child[0], int(args.child[1]), args.child[2], args.device)
        return
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe needs one NVIDIA GPU")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--device", args.device,
                 "--child", backend, str(r), store],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            for r, p in enumerate(procs):
                try:
                    so, se = p.communicate(timeout=args.timeout)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    so, se = p.communicate()
                    print(json.dumps({"backend": backend, "rank": r,
                                      "hung": f"killed after {args.timeout} s"
                                      }))
                    continue
                for ln in so.splitlines():
                    if ln.startswith("{"):
                        print(ln)
                print(json.dumps({"backend": backend, "rank": r,
                                  "exit": p.returncode,
                                  "stderr": se.strip().splitlines()[-2:]}))
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())


if __name__ == "__main__":
    main()
