"""The one-dimensional data mesh over ``torch.distributed`` (port of
``reid_gan_tpu/parallel/mesh.py``).

The JAX package runs data parallelism as one program over a 1-D ``data``
mesh: the batch is sharded over the devices, the state replicated, and XLA
inserts the collectives (the gradient ``psum``, the all-gathers of features
for the bank fold, clustering and eval). The port runs one process per card
(one rank), joined in a process group: NCCL on the card, gloo on the CPU
(the tests). The collectives XLA inserted are called explicitly here:

- ``all_reduce_grads``: the gradients' mean over the ranks, after each
  ``backward()`` and before each ``optimizer.step()``, flattened into one
  call a dtype. Every rank holds the same parameters, so the step is the
  step of one device on the whole batch, as in the JAX package;
- ``all_gather_rows``: the ranks' rows in rank order, which is the order of
  the global batch (``shard_batch`` gives each rank a contiguous slice);
  ``assemble_rows``: chosen rows of the global batch from the ranks that
  own them, in one sum;
- ``all_reduce_mean`` / ``all_reduce_sum``: logged losses and the rank
  pass's sums; ``replicate`` and ``broadcast_object``: rank 0's state.

``get_mesh`` joins (or starts) the group; ``launch`` spawns one process per
rank and propagates a rank's failure to the caller, ending the other ranks.
Every group has a timeout, so a rank that waits on a collective that never
comes raises instead of hanging.
"""

import contextlib
import datetime
import os
import pickle
import socket
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=900)


class Mesh:
    """This process's place in the data mesh: ``rank`` of ``world_size``,
    its ``device`` and the ``backend`` of the default process group, over
    which every collective here runs."""

    def __init__(self, rank, world_size, device, backend="gloo"):
        self.rank, self.world_size = rank, world_size
        self.device = torch.device(device)
        self.backend = backend

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


_MESH = None


def is_main(mesh):
    """True without a mesh, or on rank 0."""
    return mesh is None or mesh.rank == 0


def local_device_count():
    return torch.cuda.device_count()


def free_port():
    """A free TCP port on localhost, for a ``tcp://localhost:<port>``
    rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def get_mesh(n_devices=None, rank=0, init_method=None, device_type="cuda",
             timeout=DEFAULT_TIMEOUT):
    """Join (or start) the process group of a 1-D data mesh of ``n_devices``
    ranks (default: every card) as rank ``rank``, and return its ``Mesh``.

    On ``device_type`` "cuda" rank r takes card r and the group is NCCL's; a
    rank without its card raises. On "cpu" the group is gloo's. The
    rendezvous is ``init_method`` (``tcp://localhost:<port>`` or a
    ``file://`` store; default: a free localhost port, which only a group of
    one can find by itself). A group that is up already is returned as it
    is; a different size raises. Nothing falls back: a group that does not
    form within ``timeout`` raises."""
    global _MESH
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a data mesh on the card needs CUDA; none is available "
                           "(pass device_type='cpu' for a gloo mesh)")
    if n_devices is None:
        n_devices = local_device_count() if device_type == "cuda" else 1
    if dist.is_initialized():
        if _MESH is None or _MESH.world_size != n_devices:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"up already; asked for a mesh of {n_devices}")
        return _MESH
    if not 0 <= rank < n_devices:
        raise ValueError(f"rank {rank} is not in a mesh of {n_devices}")
    if device_type == "cuda":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no card: {torch.cuda.device_count()} "
                               f"visible")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, extra = "nccl", {"device_id": device}
    elif device_type == "cpu":
        device, backend, extra = torch.device("cpu"), "gloo", {}
    else:
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    if init_method is None:
        if n_devices > 1:
            raise ValueError("a mesh of several ranks needs a shared init_method")
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=n_devices, timeout=timeout, **extra)
    _MESH = Mesh(rank, n_devices, device, backend)
    return _MESH


def destroy_mesh():
    """Leave the process group (a no-op without one)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def _rank_main(rank, fn, world_size, init_method, device_type, threads, timeout,
               result_path, args):
    if threads:
        torch.set_num_threads(threads)
    mesh = get_mesh(world_size, rank, init_method, device_type, timeout)
    try:
        out = fn(mesh, *args)
    except BaseException:
        # exit at once: tearing the group down (or letting the interpreter do
        # it) can wait on the ranks that wait on this one, NCCL's above all;
        # the launch sees the exit code and ends the others
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    if rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)
    destroy_mesh()


def launch(fn, world_size, args=(), device_type="cuda", init_method=None,
           threads=None, timeout=DEFAULT_TIMEOUT):
    """Run ``fn(mesh, *args)`` in ``world_size`` spawned processes, one a
    rank, and return rank 0's result. ``fn`` must be importable by name
    (a module-level function). A rank that raises (``SystemExit`` too)
    prints its traceback and exits at once; the launch then ends the others
    and raises ``torch.multiprocessing.ProcessExitedException``. ``threads``
    sets each rank's intra-op threads."""
    import torch.multiprocessing as mp

    init_method = init_method or f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="reid_mesh_") as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_rank_main, nprocs=world_size, join=True,
                           start_method="spawn",
                           args=(fn, world_size, init_method, device_type, threads,
                                 timeout, result_path, tuple(args)))
        with open(result_path, "rb") as f:
            return pickle.load(f)


def mesh_device(mesh, device):
    """A mesh's device (a ``device`` that differs raises), else ``device``
    resolved (default: the card)."""
    from ..device import resolve_device

    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not rank {mesh.rank}'s {mesh.device}")
    return mesh.device


def wants_mesh(device, mesh=None):
    """The CLIs' rule (train_usl.py:41-44): ``mesh=False`` opts out, a
    ``Mesh`` is used as it is, and with ``mesh=None`` a run on the card
    spans every card when more than one is visible. Returns True when the
    caller should ``launch`` one rank a card."""
    return mesh is None and torch.device(device).type == "cuda" and \
        local_device_count() > 1


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):     # NamedTuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def shard_batch(mesh, tree):
    """This rank's contiguous slice of each leading axis of ``tree`` (arrays,
    tensors, lists), which is what ``batch_sharding`` places on device r in
    the JAX package. Leading dims must divide the mesh size."""
    def take(x):
        if len(x) % mesh.world_size:
            raise ValueError(f"a leading axis of {len(x)} does not split over "
                             f"{mesh.world_size} ranks; pad it (pad_to_multiple)")
        s = len(x) // mesh.world_size
        return x[mesh.rank * s:(mesh.rank + 1) * s]

    return _tree_map(take, tree)


def pad_to_multiple(array, multiple, axis=0, pad_value=0):
    """Pad ``array`` along ``axis`` so its length is a multiple of
    ``multiple``. Returns (padded, original_length)."""
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(array, pad_width, constant_values=pad_value), n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _flat_collective(tensors, op):
    """``op`` on each dtype's tensors flattened into one buffer, copied
    back in place."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = _flatten_dense_tensors(ts)
        op(flat)
        for t, u in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(u)


def replicate(mesh, tree):
    """Rank 0's values of a module's parameters and buffers, or of a tree of
    tensors (dicts, lists, NamedTuples such as a ``MemoryState``), on every
    rank, in place. Returns ``tree``."""
    if mesh is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = [t.data for t in tree.parameters()] + list(tree.buffers())
    else:
        tensors = [t for t in _leaves(tree) if torch.is_tensor(t)]
    with torch.no_grad():
        _flat_collective(tensors, lambda f: dist.broadcast(f, 0))
    return tree


def all_reduce_grads(mesh, params):
    """The mean of each gradient over the ranks, in place (the gradient
    ``psum`` XLA inserts under a sharded batch, divided by the mesh size as
    each rank's loss is its rows' mean). A parameter without a gradient is
    left out: every rank runs the same graph, so each leaves out the same
    ones."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    w = mesh.world_size

    def reduce(flat):
        dist.all_reduce(flat)
        flat.div_(w)

    with torch.no_grad():
        _flat_collective(grads, reduce)


def all_reduce_sum(mesh, t):
    """The sum over the ranks of ``t`` (a new tensor; ``t`` itself without a
    mesh)."""
    if mesh is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean(mesh, t):
    """The mean over the ranks of ``t`` (a new tensor; ``t`` itself without
    a mesh), e.g. a logged loss."""
    return t if mesh is None else all_reduce_sum(mesh, t) / mesh.world_size


def all_reduce_means(mesh, named):
    """A dict of device scalars (logged losses) with each value's mean over
    the ranks, in one reduction at their widest dtype; ``named`` itself
    without a mesh."""
    if mesh is None:
        return named
    values = list(named.values())
    dtype = values[0].dtype
    for v in values[1:]:
        dtype = torch.promote_types(dtype, v.dtype)
    return dict(zip(named, all_reduce_mean(mesh, torch.stack([v.to(dtype)
                                                              for v in values]))))


def all_gather_rows(mesh, x, n=None):
    """Every rank's ``x`` (the same shape on each) stacked in rank order
    along the leading axis, trimmed to its first ``n`` rows (the padding of
    an uneven last batch)."""
    if mesh is None:
        return x if n is None else x[:n]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x)
    out = torch.cat(parts)
    return out if n is None else out[:n]


def assemble_rows(mesh, x, rows):
    """The rows ``rows`` (global indices into the whole batch) of a tensor
    whose leading axis is sharded over the ranks as ``shard_batch`` places
    it, ``x`` being this rank's slice, on every rank: each rank writes the
    rows it owns and zeros elsewhere, and one ``all_reduce_sum`` adds them,
    which is exact (x + 0 = x). ``x[rows]`` without a mesh. No gradient."""
    if mesh is None:
        return x[rows]
    s = x.shape[0]
    own = (rows >= mesh.rank * s) & (rows < (mesh.rank + 1) * s)
    local = torch.clamp(rows - mesh.rank * s, 0, s - 1)
    with torch.no_grad():
        picked = torch.where(own.view((-1,) + (1,) * (x.dim() - 1)), x[local],
                             torch.zeros((), dtype=x.dtype, device=x.device))
    return all_reduce_sum(mesh, picked)


def broadcast_object(mesh, obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if mesh is None:
        return obj
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, 0,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


@contextlib.contextmanager
def main_prints(mesh):
    """Within the block only rank 0 prints: the other ranks' stdout goes to
    ``os.devnull``."""
    if is_main(mesh):
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def main_first(mesh, fn):
    """``fn()`` on rank 0, then on the other ranks (e.g. a dataset that
    writes its files on first use). Returns ``fn()``'s result."""
    if mesh is None:
        return fn()
    out = fn() if mesh.rank == 0 else None
    mesh.barrier()
    return out if mesh.rank == 0 else fn()

