"""Which collectives a process group performs on CUDA tensors.

Starts ``--world`` processes on one card (``cuda:0``), joins them by the
given backend over ``tcp://127.0.0.1:<free port>``, and tries, each on a
small CUDA tensor with a known answer: ``all_reduce``, ``broadcast``,
``all_gather`` (a list), ``all_gather_into_tensor``, ``reduce_scatter`` (a
list), ``reduce_scatter_tensor``, ``all_to_all_single``, blocking and
non-blocking point-to-point (``send`` / ``recv``, ``isend`` / ``irecv``),
then one DDP step and one FSDP2 (``fully_shard``) step of a small model on
the card.  Each answer is ``"ok"``, ``"wrong"`` or the first line of the
error it raised.  Prints one JSON object per rank, keyed by rank; the
process exits 0 whatever the answers are (a rank that hangs is killed at
``--timeout`` and reported as such).

    python tools/dist_probe.py [--world 2] [--backend gloo] [--device cuda]
                               [--out f.json]

``probe(world, backend)`` is the same from Python (``chip_smoke.py``
phase 26 calls it).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile

#: in the order they run; point-to-point last, since a rank that fails
#: there may take its process down with it
COLLECTIVES = (
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all_single",
    "ddp_step", "fsdp2_step", "send_recv", "isend_irecv",
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _first_line(exc: BaseException) -> str:
    text = f"{type(exc).__name__}: {exc}".strip()
    return text.splitlines()[0][:200]


def _checks(rank: int, world: int, dev):
    """name -> a function that runs the collective and returns True when
    its answer is right."""
    import torch
    import torch.distributed as dist

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def broadcast():
        t = torch.full((4,), float(rank), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 0).all())

    def all_gather():
        outs = [torch.empty(3, device=dev) for _ in range(world)]
        dist.all_gather(outs, torch.full((3,), float(rank), device=dev))
        return all(bool((o == r).all()) for r, o in enumerate(outs))

    def all_gather_into_tensor():
        out = torch.empty(world * 3, device=dev)
        dist.all_gather_into_tensor(out, torch.full((3,), float(rank), device=dev))
        return bool((out.view(world, 3) == torch.arange(world, device=dev)[:, None]).all())

    def reduce_scatter():
        out = torch.empty(3, device=dev)
        dist.reduce_scatter(out, [torch.full((3,), float(r), device=dev) for r in range(world)])
        return bool((out == world * rank).all())

    def reduce_scatter_tensor():
        out = torch.empty(3, device=dev)
        src = torch.arange(world, device=dev, dtype=torch.float32).repeat_interleave(3)
        dist.reduce_scatter_tensor(out, src)
        return bool((out == world * rank).all())

    def all_to_all_single():
        src = torch.full((world,), float(rank), device=dev)
        out = torch.empty(world, device=dev)
        dist.all_to_all_single(out, src)
        return bool((out == torch.arange(world, device=dev)).all())

    def send_recv():
        t = torch.full((3,), float(rank), device=dev)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            dist.send(t, nxt)
            got = torch.empty(3, device=dev)
            dist.recv(got, prv)
        else:
            got = torch.empty(3, device=dev)
            dist.recv(got, prv)
            dist.send(t, nxt)
        return bool((got == prv).all())

    def isend_irecv():
        t = torch.full((3,), float(rank), device=dev)
        got = torch.empty(3, device=dev)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        reqs = [dist.isend(t, nxt), dist.irecv(got, prv)]
        for r in reqs:
            r.wait()
        return bool((got == prv).all())

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                   torch.nn.Linear(16, 2)).to(dev)

    def ddp_step():
        from torch.nn.parallel import DistributedDataParallel

        m = DistributedDataParallel(model())
        x = torch.full((4, 8), float(rank + 1), device=dev)
        m(x).sum().backward()
        g = m.module[0].weight.grad.clone()
        dist.all_reduce(g)
        return bool(torch.allclose(g / world, m.module[0].weight.grad))

    def fsdp2_step():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("data",))
        m = fully_shard(model(), mesh=mesh)
        x = torch.full((4, 8), float(rank + 1), device=dev)
        m(x).sum().backward()
        grad = m[0].weight.grad
        return bool(torch.isfinite(grad.full_tensor()).all())

    fns = dict(all_reduce=all_reduce, broadcast=broadcast, all_gather=all_gather,
               all_gather_into_tensor=all_gather_into_tensor,
               reduce_scatter=reduce_scatter, reduce_scatter_tensor=reduce_scatter_tensor,
               all_to_all_single=all_to_all_single, send_recv=send_recv,
               isend_irecv=isend_irecv, ddp_step=ddp_step, fsdp2_step=fsdp2_step)
    return {name: fns[name] for name in COLLECTIVES}


def worker(rank: int, world: int, port: int, backend: str, out: str,
           device: str = "cuda", only=()) -> None:
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    res = {}
    for name, fn in _checks(rank, world, dev).items():
        if only and name not in only:
            continue
        try:
            res[name] = "ok" if fn() else "wrong"
        except Exception as exc:  # the answer is the error
            res[name] = _first_line(exc)
        if device == "cuda":
            torch.cuda.synchronize()
        with open(out, "w") as fh:  # what was answered survives a crash after
            json.dump(res, fh)
    dist.destroy_process_group()


def probe(world: int = 2, backend: str = "gloo", timeout: float = 300.0,
          device: str = "cuda", only=()) -> dict:
    """Run the checks (``only`` those named, if given) in ``world`` processes
    on ``cuda:0`` (or the CPU); ``{rank: {name: answer}}``.  A rank that
    exits before it answers them all also reads ``"exit"``, its exit
    code; one killed at ``timeout`` reads ``"killed"``."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                   str(r), "--world", str(world), "--port", str(port),
                                   "--backend", backend, "--out", outs[r],
                                   "--device", device, "--only", ",".join(only)])
                 for r in range(world)]
        res = {}
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                res[r] = {"killed": f"no answer within {timeout} s"}
                continue
            res[r] = {}
            if os.path.exists(outs[r]):
                with open(outs[r]) as fh:
                    res[r] = json.load(fh)
            if p.returncode:
                res[r]["exit"] = p.returncode
        return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--only", default="", help="comma-separated names of the checks to run")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        worker(a.worker, a.world, a.port, a.backend, a.out, a.device,
               tuple(n for n in a.only.split(",") if n))
        return
    import torch

    res = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "backend": a.backend, "world": a.world, "device": a.device,
           "ranks": probe(a.world, a.backend, a.timeout, a.device,
                          tuple(n for n in a.only.split(",") if n))}
    text = json.dumps(res, indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
