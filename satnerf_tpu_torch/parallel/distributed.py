"""Processes of one training run, one a device (counterpart of
satnerf_tpu/parallel/distributed.py).

The JAX package runs one SPMD program over a mesh of every process's chips;
here each device has a process of its own, and the processes form one
torch.distributed group: NCCL on the card, gloo on the CPU. Every process
holds the whole model and trains on its own block of rays (mesh.py); the
step's gradients and metrics are averaged by one all-reduce each
(`all_reduce_mean`), as `pmean` averages them in the JAX step. Only rank 0
writes: logs, opts.json, checkpoints, product dumps, scores.

Rendering (validation and the eval entry points) runs on the render group:
the ranks on rank 0's host, built once at the join, the counterpart of the
JAX system's `eval_mesh` (this process's local devices). Each of its ranks
renders its block of every chunk's rows and `all_gather_rows` hands every
rank the whole products (train/system.py `render_image`); ranks on other
hosts render nothing.

The environment contract is the JAX package's, set a process by the
launcher:

    SATNERF_COORDINATOR=host0:12345   # rank 0's address and a free port
    SATNERF_NUM_PROCS=2               # the number of processes
    SATNERF_PROC_ID=0                 # this process's rank

Each process takes the card `cuda:{rank % torch.cuda.device_count()}`.
Without a coordinator, `cli.train --n_devices N` starts the N processes
itself on one host (`spawn`): the caller's process is rank 0 and N - 1
children take ranks 1.., as one JAX process drives an N-device mesh
(`make_mesh`: 0 means every visible device, 1 a run of one process).

A rank that fails ends the run rather than leaving the others waiting out
TIMEOUT: every process must join within JOIN_TIMEOUT; a non-finite loss
stops every rank at the same step (train/loop.py); under `spawn`, a child
that fails makes rank 0's collectives fail, and a rank 0 that fails ends
the children.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import threading
import time

import torch
import torch.distributed as dist

ENV = ("SATNERF_COORDINATOR", "SATNERF_NUM_PROCS", "SATNERF_PROC_ID")
# The render group validates while ranks on other hosts wait at the next
# all-reduce, and rank 0 scores and writes checkpoints while the others wait,
# so a collective may wait as long as a validation pass takes: the group's
# timeout is far past any of those.
TIMEOUT = datetime.timedelta(hours=3)
# every process must have joined within this (jax.distributed.initialize's
# initialization_timeout)
JOIN_TIMEOUT = datetime.timedelta(seconds=300)
# the ranks on rank 0's host and their group (None: the default group),
# set at the join; () outside a group
_RENDER = {"ranks": (), "group": None}


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    """True on the process that owns the run's IO."""
    return rank() == 0


def maybe_init_distributed(device_type: str = "cuda") -> int:
    """Join the process group when SATNERF_COORDINATOR is set (no-op
    otherwise, and when already joined). On the card the process first
    takes cuda:{rank % device_count}. Returns the world size (1 when not
    distributed)."""
    coord = os.environ.get("SATNERF_COORDINATOR")
    if not coord:
        return 1
    if not is_distributed():
        size = int(os.environ["SATNERF_NUM_PROCS"])
        r = int(os.environ["SATNERF_PROC_ID"])
        if device_type == "cuda":
            torch.cuda.set_device(r % torch.cuda.device_count())
        host, port = coord.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), size, is_master=r == 0,
                              timeout=JOIN_TIMEOUT)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", store=store,
            world_size=size, rank=r, timeout=TIMEOUT)
        if device_type == "cuda":
            # NCCL makes its communicator at the first collective, through
            # the store: make it while every rank is here
            dist.barrier(device_ids=[torch.cuda.current_device()])
        _join_render_group(store, size, r)
    return world()


def _join_render_group(store, size: int, r: int) -> None:
    """Every rank: publish this host's name, read the others', and make the
    render group of the ranks on rank 0's host (collective: new_group is
    called by every rank alike)."""
    store.set(f"render_host/{r}", socket.gethostname())
    hosts = [store.get(f"render_host/{i}").decode() for i in range(size)]
    ranks = tuple(i for i, h in enumerate(hosts) if h == hosts[0])
    group = None if len(ranks) == size else dist.new_group(list(ranks))
    _RENDER.update(ranks=ranks, group=group)


def render_world() -> int:
    """The ranks that render: those on rank 0's host (1 outside a group)."""
    return len(_RENDER["ranks"]) if is_distributed() else 1


def render_rank() -> int:
    """This process's place in the render group (0 outside a group)."""
    return _RENDER["ranks"].index(rank()) if is_distributed() else 0


def renders() -> bool:
    """True on a process that renders: every rank on rank 0's host, and the
    process of a run without a group."""
    return not is_distributed() or rank() in _RENDER["ranks"]


def all_gather_rows(products: dict) -> dict:
    """Each render rank's equal block of rows of every product tensor ->
    the whole products on every rank of the render group, the blocks in
    rank order. One all-gather a dtype over one flat buffer (gloo has no
    all_gather_into_tensor: a list there). A no-op outside a group."""
    w = render_world()
    if w == 1:
        return products
    group = _RENDER["group"]
    nccl = dist.get_backend(group) == "nccl"
    out = {}
    for dtype in dict.fromkeys(v.dtype for v in products.values()):
        keys = [k for k, v in products.items() if v.dtype == dtype]
        flat = torch.cat([products[k].reshape(-1) for k in keys])
        if nccl:
            whole = flat.new_empty((w, flat.numel()))
            dist.all_gather_into_tensor(whole, flat, group=group)
        else:
            parts = [torch.empty_like(flat) for _ in range(w)]
            dist.all_gather(parts, flat, group=group)
            whole = torch.stack(parts)
        offset = 0
        for k in keys:
            v = products[k]
            out[k] = whole[:, offset:offset + v.numel()].reshape(
                w * v.shape[0], *v.shape[1:])
            offset += v.numel()
    return {k: out[k] for k in products}


def local_device(device_type: str) -> torch.device:
    """This process's device: cuda:{rank % count} on the card, else cpu."""
    if device_type == "cuda":
        return torch.device("cuda", rank() % torch.cuda.device_count())
    return torch.device(device_type)


def rank_device(device) -> torch.device:
    """The device this process runs on: its card in a group, else `device`."""
    device = torch.device(device)
    return local_device(device.type) if is_distributed() else device


def run_in_group(fn, args, n_devices: int, device_type: str):
    """fn(*args) on every rank of a group: with SATNERF_COORDINATOR set this
    process joins it as its rank; without it, n_devices (device_count's
    rule) > 1 starts the ranks on this host (`spawn`), else fn runs alone.
    The ranks meet at a barrier after fn; a group this call joined it also
    leaves. Returns this process's result (rank 0's under `spawn`)."""
    if not os.environ.get("SATNERF_COORDINATOR"):
        n = device_count(n_devices, device_type)
        if n > 1:
            return spawn(run_in_group, (fn, args, n_devices, device_type), n)
    joined = is_distributed()
    maybe_init_distributed(device_type)
    try:
        out = fn(*args)
        barrier()  # where the JAX package calls sync_global_devices
        return out
    finally:
        if not joined:
            destroy()


def all_reduce_mean(tensors) -> None:
    """Average each tensor across the ranks in place: one all-reduce of one
    flat float32 buffer (the tensors are float32 on one device)."""
    tensors = list(tensors)
    if not is_distributed() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def barrier() -> None:
    """Every rank waits here for the others (sync_global_devices)."""
    if is_distributed():
        dist.barrier()


def destroy() -> None:
    """Leave the process group, so that a later run in this process joins
    its own."""
    if is_distributed():
        dist.destroy_process_group()
    _RENDER.update(ranks=(), group=None)


def device_count(n_devices: int, device_type: str) -> int:
    """The processes `--n_devices` asks for: 0 means every visible card (one
    on the CPU); more cards than are visible is refused."""
    if device_type != "cuda":
        return max(n_devices, 1)
    visible = torch.cuda.device_count()
    n = visible if n_devices == 0 else n_devices
    if n > visible:
        raise ValueError(f"--n_devices {n_devices}: only {visible} CUDA "
                         f"device(s) visible")
    return n


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(fn, args, env: dict) -> None:
    os.environ.update(env)
    fn(*args)


def _abort() -> None:
    """Make this process's waiting and later collectives fail. A gloo
    collective fails by itself once a peer's process has ended (its socket
    closes); an NCCL one would wait out TIMEOUT."""
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if is_distributed() and dist.get_backend() == "nccl" and abort is not None:
        abort()


def _stop(children, grace: float) -> list:
    """Wait up to `grace` seconds in all for the children to end, then end
    the rest. Returns the ranks of those that had ended with an error."""
    deadline = time.monotonic() + grace
    for c in children:
        c.join(max(deadline - time.monotonic(), 0))
    ended = [r for r, c in enumerate(children, 1) if c.exitcode not in (None, 0)]
    for c in children:
        if c.is_alive():
            c.terminate()
            c.join(5)
        if c.is_alive():
            c.kill()
            c.join()
    return ended


def spawn(fn, args, n: int):
    """Run fn(*args) as ranks 0..n-1 of one group on this host: ranks 1..n-1
    in child processes (started fresh, `spawn`), rank 0 in this process.
    Returns rank 0's result. A rank that fails ends the run within seconds:
    a child that exits with an error makes rank 0's collectives fail (a
    thread watches the children), and when rank 0 raises, the children are
    ended. Raises rank 0's error (noting the children that had failed), or
    names the children that failed."""
    base = {"SATNERF_COORDINATOR": f"localhost:{_free_port()}",
            "SATNERF_NUM_PROCS": str(n)}
    ctx = multiprocessing.get_context("spawn")
    children = [ctx.Process(target=_child,
                            args=(fn, args, {**base, "SATNERF_PROC_ID": str(r)}))
                for r in range(1, n)]
    for c in children:
        c.start()
    done = threading.Event()

    def watch():
        while not done.wait(0.5):
            if any(c.exitcode not in (None, 0) for c in children):
                _abort()
                return

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update({**base, "SATNERF_PROC_ID": "0"})
    try:
        out = fn(*args)
    except BaseException as e:
        ended = _stop(children, grace=1)
        if ended:
            e.add_note(f"rank(s) {ended} of {n} failed too")
        raise
    finally:
        done.set()
        watcher.join()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # every rank has passed the run's last barrier: the children only leave
    # the group
    _stop(children, grace=60)
    failed = [r for r, c in enumerate(children, 1) if c.exitcode != 0]
    if failed:
        raise RuntimeError(f"rank(s) {failed} of {n} failed")
    return out
