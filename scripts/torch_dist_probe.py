"""Which torch.distributed backends carry which collectives on this machine's
card: NCCL at world 1 and 2, and gloo at world 2 with CUDA tensors, every
rank on cuda:0 (two ranks on one card is how chip_smoke.py's multi_device
phase runs a world of 2). Prints the Python, torch, CUDA and NCCL versions,
the card's name and power limit, then one JSON line a (backend, world):
for each rank, "ok" or the error of each collective, of a point-to-point exchange
around the ring (batch_isend_irecv, i -> i + 1; world 2 only, last, as a
failure there can end the process; the results before it are kept) and of
a DeviceMesh. A rank left waiting is killed after 90 s.

    python3 scripts/torch_dist_probe.py       # on a machine with a CUDA card
"""

import datetime
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _outcome(fn) -> str:
    """'ok', or the error fn raised (a probe records a refusal)."""
    try:
        fn()
        torch.cuda.synchronize()
        return "ok"
    except Exception as ex:  # noqa: BLE001 - the outcome is what is probed
        return repr(ex)[:300]


def worker(rank, world, backend, path, out):
    res = {"init": _outcome(lambda: dist.init_process_group(
        backend, init_method=f"file://{path}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60)))}
    if res["init"] != "ok":
        out[rank] = res
        return
    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    x = torch.full((8,), float(rank + 1), device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=dev), x),
        "all_gather": lambda: dist.all_gather([torch.empty(8, device=dev)
                                               for _ in range(world)], x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=dev), x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty(8, device=dev),
                                                            x.clone()),
    }

    def mesh():
        from torch.distributed.device_mesh import DeviceMesh

        m = DeviceMesh("cuda", torch.arange(world).reshape(world, 1),
                       mesh_dim_names=("data", "model"))
        dist.all_reduce(x.clone(), group=m.get_group("data"))

    def ring():
        ops = [dist.P2POp(dist.isend, x.clone(), (rank + 1) % world),
               dist.P2POp(dist.irecv, torch.empty(8, device=dev), (rank - 1) % world)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    calls["device_mesh"] = mesh
    if world > 1:  # last: on gloo with CUDA tensors it can end the process
        calls["batch_isend_irecv"] = ring
    for name, fn in calls.items():
        res[name] = _outcome(fn)
        out[rank] = dict(res)  # kept if a later call ends the process
    dist.destroy_process_group()


def main() -> None:
    nccl = torch.cuda.nccl.version() if torch.cuda.is_available() else None
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, nccl)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    for backend, world in (("nccl", 1), ("nccl", 2), ("gloo", 2)):
        path = os.path.join(tempfile.gettempdir(), f"dist_probe_{backend}_{world}")
        if os.path.exists(path):
            os.remove(path)
        with mp.Manager() as manager:
            out = manager.dict()
            ctx = mp.spawn(worker, args=(world, backend, path, out), nprocs=world, join=False)
            joined = True
            for proc in ctx.processes:
                proc.join(90)
                if proc.is_alive():
                    proc.kill()
                    joined = False
            print(json.dumps({"backend": backend, "world": world, "joined": joined,
                              "exitcodes": [p.exitcode for p in ctx.processes],
                              "ranks": dict(out)}))


if __name__ == "__main__":
    main()
