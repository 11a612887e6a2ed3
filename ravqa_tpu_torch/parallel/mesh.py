"""The device mesh over torch.distributed, its collectives, and the
launcher that starts one process per shard.

Port of ravqa_tpu/parallel/mesh.py (:21-48). The JAX package runs one SPMD
program over a jax.sharding.Mesh with named axes ("data" for batches and
the index's validation shards, "index" for a serving index, "model" for
tensor parallelism). The port runs one process per rank over a
torch.distributed DeviceMesh with the same axis names; an array
"sharded over an axis" (JAX's P(axis)) is, on the rank at position r of
that axis, the contiguous rows [r * n_local, (r + 1) * n_local) of dim 0.

The backend (choose_backend): NCCL where each rank owns a card; gloo on
the CPU and where ranks share a card (NCCL refuses two ranks on one GPU).
gloo's CUDA support covers few collectives, so the collectives here
(all_gather, all_reduce, broadcast) copy a CUDA tensor through the host
when the group is gloo's, explicitly; the compute stays on the card.

launch(fn, n, ...) runs fn(*args) on n ranks: spawned processes, each
joined to a process group through a fresh file:// rendezvous (no fixed
port, so concurrent launches never collide) with a timeout, or, in a
process that torchrun started (WORLD_SIZE set), this process joined to
torchrun's group. A rank that raises has its traceback re-raised by the
parent, which kills the other ranks rather than leave them blocked in a
collective.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# the device of this rank, set by init_rank (None: not a launched rank)
_RANK_DEVICE: Optional[torch.device] = None


def ranks_on_this_host(world_size: int) -> int:
    """The ranks that share this host's cards: torchrun's
    LOCAL_WORLD_SIZE (a multi-node run), else every rank (launch spawns
    them all here)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def choose_backend(device: str, world_size: int) -> str:
    """"nccl" where each rank owns a card (no more ranks on this host than
    it has cards), else "gloo" (the CPU, or ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if ranks_on_this_host(world_size) <= torch.cuda.device_count() \
            and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def rank_device(device: str, rank: int, backend: str) -> torch.device:
    """The rank's device: under NCCL the card of its place on this host
    (torchrun's LOCAL_RANK, else the rank), under gloo the one card
    (cuda:0, or the index `device` names), else the CPU."""
    d = torch.device(device)
    if d.type != "cuda":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return torch.device("cuda", d.index or 0)


def init_rank(rank: int, world_size: int, device: str = "cpu",
              init_method: Optional[str] = None,
              timeout: float = 60.0) -> torch.device:
    """Join this process to the group (env:// under torchrun when
    init_method is None) over choose_backend's backend and print it and
    the rank's device on one line. Returns the rank's device."""
    global _RANK_DEVICE
    backend = choose_backend(device, world_size)
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout),
        **({"device_id": dev} if backend == "nccl" else {}))
    _RANK_DEVICE = dev
    # one write, so the ranks' lines do not run together in a shared log
    line = f"[rank {rank}/{world_size}] backend {backend} device {dev}\n"
    try:
        sys.stdout.flush()
        os.write(sys.stdout.fileno(), line.encode())
    except (AttributeError, OSError, ValueError):  # a stdout without an fd
        print(line, end="", flush=True)
    return dev


def local_device() -> torch.device:
    """This rank's device (the CPU outside a launched rank)."""
    return _RANK_DEVICE if _RANK_DEVICE is not None else torch.device("cpu")


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ \
        and not dist.is_initialized()


def _exit_with_parent(parent: int) -> None:
    """End this rank when the launching process is gone (killed, say),
    rather than leave it blocked in a collective."""
    import threading

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _worker(rank, world_size, device, init_method, timeout, threads, job,
            results, parent):
    _exit_with_parent(parent)
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        init_rank(rank, world_size, device, init_method, timeout)
        # pickled here: the queue's own pickler would pass tensors as
        # shared-memory handles, which die with this process
        results.put((rank, "ok", pickle.dumps(fn(*args))))
    except BaseException:                              # noqa: BLE001
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:                          # noqa: BLE001
                pass


def launch(fn: Callable, world_size: int, *args, device: str = "cpu",
           timeout: float = 60.0, join_timeout: Optional[float] = 600.0,
           threads: int = 1) -> list:
    """Run fn(*args) on `world_size` ranks; returns each rank's result, in
    rank order. Under torchrun, joins this process to torchrun's group and
    returns [fn(*args)] (world_size must then equal WORLD_SIZE).
    Otherwise spawns the ranks (the "spawn" start method: a parent that
    has CUDA initialized cannot fork), each joined through a fresh
    file:// rendezvous, with a process-group `timeout` in seconds.
    `join_timeout` (None: no bound) bounds the whole run: past it, or as
    soon as one rank raises (or dies), every rank is killed and a
    RuntimeError carries the failing rank's traceback. `threads` sets each spawned rank's torch threads
    (0: torch's default). fn must be importable by name (a module-level
    function) and its result picklable."""
    if under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks, {world_size} asked for")
        init_rank(int(os.environ["RANK"]), world_size, device,
                  timeout=timeout)
        return [fn(*args)]
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ravqa_rdzv_")
    init_method = "file://" + os.path.join(tmp, "store")
    # the job goes by file, not through the process's start pipe: a rank
    # that dies while it starts would leave the parent blocked writing
    # large arguments into that pipe
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world_size, device, init_method, timeout,
                               threads, job, results, os.getpid()))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    error = None
    deadline = time.monotonic() + (join_timeout if join_timeout is not None
                                   else float("inf"))
    try:
        while len(out) < world_size and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = (f"ranks {sorted(set(range(world_size)) - set(out))}"
                         f" did not finish within {join_timeout} s")
                break
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    # a rank killed outright (no traceback queued): give
                    # the queue a moment, then report its exit code
                    try:
                        rank, status, value = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        error = (f"rank {dead[0]} exited with code "
                                 f"{procs[dead[0]].exitcode}")
                        break
                else:
                    continue
            if status == "ok":
                out[rank] = pickle.loads(value)
            else:
                error = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if error is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(world_size)]


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def make_mesh(axes: Optional[dict] = None, devices=None):
    """A DeviceMesh over the default group's ranks. axes: {name: size},
    default {"data": world size}; the sizes' product must be the world
    size. devices: the device type of the mesh's tensors ("cuda" or
    "cpu"; default this rank's device's type)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.launch or torchrun)")
    ws = dist.get_world_size()
    if axes is None:
        axes = {"data": ws}
    shape = tuple(int(v) for v in axes.values())
    n = int(np.prod(shape))
    if n != ws:
        raise ValueError(f"mesh {axes} needs {n} ranks, the group has {ws}")
    dtype = devices if isinstance(devices, str) else (
        torch.device(devices).type if devices is not None
        else local_device().type)
    return init_device_mesh(dtype, shape, mesh_dim_names=tuple(axes))


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def mesh_axis_size(mesh, axis) -> int:
    """Shard count over `axis`: one mesh axis name or a tuple of names
    (their sizes' product), as ravqa_tpu/retrieval/search.py:31-40."""
    names = mesh.mesh_dim_names
    return int(np.prod([mesh.shape[names.index(a)] for a in _axes(axis)]))


def axis_rank(mesh, axis) -> int:
    """This rank's position along `axis` (a tuple of axes counts the first
    axis as the most significant, as JAX's P((a, b)) orders shards)."""
    names = mesh.mesh_dim_names
    r = 0
    for a in _axes(axis):
        r = r * mesh.shape[names.index(a)] + mesh.get_local_rank(a)
    return r


def axis_group(mesh, axis):
    """The process group over `axis` (one group for a tuple of axes)."""
    axes = _axes(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(mesh.mesh_dim_names) and \
            mesh_axis_size(mesh, axes) == dist.get_world_size():
        if list(axes) != list(mesh.mesh_dim_names):
            raise ValueError(f"axes {axes} must follow the mesh's order "
                             f"{mesh.mesh_dim_names}")
        return dist.group.WORLD
    return mesh[axes]._flatten().get_group()


def replicated(mesh):
    """The placement of a replicated array: every rank holds all of it."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def batch_sharding(mesh, axis: str = "data"):
    """The placement of an array whose dim 0 is sharded over `axis`."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


def shard_rows(n: int, mesh, axis="data") -> slice:
    """This rank's rows of a dim of size n sharded over `axis` (n must
    divide evenly, as jax.device_put with P(axis) requires)."""
    ns = mesh_axis_size(mesh, axis)
    if n % ns:
        raise ValueError(f"dim 0 of size {n} does not divide over {ns} "
                         f"shards of axis {axis!r}")
    r = axis_rank(mesh, axis)
    return slice(r * (n // ns), (r + 1) * (n // ns))


def shard_batch(batch: dict, mesh, axis: str = "data") -> dict:
    """This rank's dim-0 slice of every array (numpy, tensor or list) of
    the global batch; other values pass through. A batch of B rows gives
    rank r rows [r * B / n, (r + 1) * B / n), JAX's P(axis) order."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list, tuple)) \
                and len(v) > 0 and getattr(v, "ndim", 1) > 0:
            out[k] = v[shard_rows(len(v), mesh, axis)]
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Collectives (through the host where gloo holds CUDA tensors)
# ---------------------------------------------------------------------------

# torch 2.13 names it all_gather_single (all_gather_into_tensor before)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _through_host(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(*shape) on each rank -> (world, *shape), rank-major. Not
    differentiable (partition.gather_rows is)."""
    ws = dist.get_world_size(group)
    host = _through_host(x, group)
    src = (x.detach().cpu() if host else x.detach()).reshape(1, -1)
    out = src.new_empty((ws, src.shape[1]))
    _all_gather_single(out, src.contiguous(), group=group)
    out = out.reshape((ws,) + tuple(x.shape))
    return out.to(x.device) if host else out


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """In-place all_reduce of x (also returned)."""
    if _through_host(x, group):
        h = x.detach().cpu()
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A sharded DTensor's whole value on every rank, gathered by
    all_gather (so through the host on gloo), for evenly sharded dims as
    FSDP keeps them here; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    for mesh_dim, pl in reversed(list(enumerate(t.placements))):
        if isinstance(pl, Shard):
            parts = all_gather(local.contiguous(),
                               t.device_mesh.get_group(mesh_dim))
            local = torch.cat(list(parts.unbind(0)), dim=pl.dim)
    return local


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast of x from global rank `src` (also returned)."""
    if _through_host(x, group):
        h = x.detach().cpu()
        dist.broadcast(h, src=src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src=src, group=group)
    return x


def broadcast_object(obj, src: int = 0, group=None):
    """A picklable object from global rank `src` to every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group,
                               device=torch.device("cpu")
                               if dist.get_backend(group) == "gloo"
                               else local_device())
    return box[0]


def rank_zero() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(group=None) -> None:
    if dist.is_initialized():
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[local_device().index])
        else:
            dist.barrier(group=group)


__all__ = ["all_gather", "all_reduce", "axis_group", "axis_rank",
           "barrier", "batch_sharding", "broadcast", "broadcast_object",
           "choose_backend", "full_tensor", "init_rank", "launch",
           "local_device",
           "make_mesh", "mesh_axis_size", "rank_device", "rank_zero",
           "replicated", "shard_batch", "shard_rows", "under_torchrun"]
