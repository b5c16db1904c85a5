#!/usr/bin/env python3
"""Which collectives a gloo group runs on CUDA tensors: two gloo ranks
sharing ``cuda:0`` (as the smoke's ``fleet_sharded`` and ``model_mesh``
phases run them) try each collective that DTensor's redistributions and
the port's code run, the c10d call and its functional form, and check
the result.

    python3 tools/gloo_cuda_probe.py [--device cpu]

Each collective runs in a pair of fresh processes (a collective that
kills its process, as a segmentation fault does, is reported as such and
does not stop the others). Prints one JSON line a collective, ``{"op",
"ok", "error"}``, from the first rank; exits 0 whatever the answers (the
answers are the result).
"""
import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _cases(dev, rank, world):
    from torch.distributed import _functional_collectives as funcol
    x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return torch.allclose(y, 2 * torch.arange(4 * world, device=dev)
                              .float() + sum(range(world)))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return torch.equal(y, torch.arange(4 * world, device=dev).float())

    def all_gather():
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        return all(torch.equal(o, x - rank + r) for r, o in enumerate(out))

    def all_gather_into_tensor():
        out = torch.empty(world * x.numel(), device=dev)
        dist.all_gather_into_tensor(out, x)
        return torch.equal(out[x.numel():2 * x.numel()], x - rank + 1)

    def reduce_scatter_tensor():
        out = torch.empty(x.numel() // world, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out.numel() == 4

    def all_to_all_single():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out.numel() == x.numel()

    def funcol_all_reduce():
        y = funcol.wait_tensor(funcol.all_reduce(x, "sum", dist.group.WORLD))
        return y.numel() == x.numel()

    def funcol_all_reduce_max():
        y = funcol.wait_tensor(funcol.all_reduce(x, "max", dist.group.WORLD))
        return torch.equal(y, x - rank + world - 1)

    def funcol_all_gather_into_tensor():
        y = funcol.wait_tensor(funcol.all_gather_tensor(x, 0,
                                                        dist.group.WORLD))
        return y.numel() == world * x.numel()

    def funcol_reduce_scatter_tensor():
        y = funcol.wait_tensor(funcol.reduce_scatter_tensor(
            x, "sum", 0, dist.group.WORLD))
        return y.numel() == x.numel() // world

    def funcol_all_to_all_single():
        y = funcol.wait_tensor(funcol.all_to_all_single(
            x, None, None, dist.group.WORLD))
        return y.numel() == x.numel()

    def broadcast_object_list():
        box = [{"rank": rank}]
        dist.broadcast_object_list(box, src=0)
        return box[0] == {"rank": 0}

    return [all_reduce, broadcast, all_gather, all_gather_into_tensor,
            reduce_scatter_tensor, all_to_all_single, funcol_all_reduce,
            funcol_all_reduce_max, funcol_all_gather_into_tensor,
            funcol_reduce_scatter_tensor, funcol_all_to_all_single,
            broadcast_object_list]


def rank_main(rank, world, init, device, which, out):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    rows = []
    try:
        for case in _cases(torch.device(device), rank, world)[which:which
                                                              + 1]:
            try:
                ok = bool(case())
                if device == "cuda":
                    torch.cuda.synchronize()
                rows.append({"op": case.__name__, "ok": ok, "error": None})
            except Exception as e:  # noqa: BLE001 - the answer is the row
                rows.append({"op": case.__name__, "ok": False,
                             "error": f"{type(e).__name__}: {e}"[:300]})
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe: no CUDA device")
    print(json.dumps({"torch": torch.__version__, "device": args.device}))
    names = [c.__name__ for c in _cases("cpu", 0, 2)]
    for which, name in enumerate(names):
        out = tempfile.mkdtemp()
        try:
            mp.start_processes(rank_main, args=(2, os.path.join(out, "init"),
                                                args.device, which, out),
                               nprocs=2, start_method="spawn")
            with open(os.path.join(out, "rank0.json")) as f:
                row = json.load(f)[0]
        except mp.ProcessExitedException as e:
            row = {"op": name, "ok": False,
                   "error": f"the rank died: {e}"[:300]}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
