"""Device meshes on torch.distributed, the batch split and the TL-TR split
rules.

Counterpart of `whisper_at_tpu/parallel/mesh.py`. The JAX package runs one
controller over a `jax.sharding.Mesh` and lets XLA insert the collectives.
Here the programming model is SPMD: one process a rank, every rank calling
the same entry point with the same arguments, and the collectives written
out where the data path needs them. A `Mesh` holds the process groups of
its named axes:

  dp  data parallel: each dp rank takes its share of the batch (windows,
      training rows); nothing is exchanged inside a decode.
  tp  tensor parallel: the Megatron column / row split of the attention
      and MLP weights (`parallel/tensor.py`), one all-reduce after each
      row-split product.
  pp  pipeline stages of the encoder (`parallel/pipeline.py`).
  sp  sequence shards of the encoder (`parallel/sequence.py`).

Rank r of a ('dp', 'tp') mesh sits at (r // tp, r % tp), the layout of the
JAX package's `devices.reshape(dp, tp)`. The process group comes from
`init_distributed` (or from the caller): NCCL for the card, gloo for the
CPU. Two ranks sharing one card need gloo, which carries CUDA tensors for
all_reduce and broadcast only; the helpers below stage every other
collective's CUDA tensors through host memory when the group's backend is
gloo, decided by that backend, and say so in one printed line.

Every group is made with a timeout (60 s unless `init_distributed` is given
another), so a rank that never joins fails the others instead of hanging
them.
"""

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0
_timeout_s = DEFAULT_TIMEOUT_S  # the groups' timeout: init_distributed's, else the default
_announced = set()


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=_timeout_s)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start this process's default process group unless one is running:
    NCCL on the card, gloo on the CPU (or `backend`). Without arguments it
    reads torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); tests pass `init_method="file://..."`, world_size and
    rank."""
    global _timeout_s
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    _timeout_s = float(timeout_s)
    kwargs = dict(backend=backend, init_method=init_method or "env://",
                  timeout=datetime.timedelta(seconds=timeout_s))
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    if dev.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(local_device(dev))
    dist.init_process_group(**kwargs)


def local_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK (else the global
    rank) modulo the cards present, so ranks of one host spread over its
    cards and several ranks may share one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """Named axes over the ranks of the default process group.

    `shape` is {axis: size} in order; `coords` this rank's index on each
    axis; `groups[axis]` the group of the ranks that differ from this one
    on that axis alone, `ranks[axis]` their global ranks in axis order;
    `world` the group of every rank of the mesh. `device` is this rank's
    device, `backend` the groups' backend."""

    def __init__(self, shape: Dict[str, int], device):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call parallel.mesh.init_distributed() in "
                               "every rank first (torchrun sets its environment)")
        n = 1
        for size in shape.values():
            n *= size
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"a mesh {dict(shape)} of {n} ranks over a process group of "
                             f"{world}")
        self.shape = dict(shape)
        self.device = local_device(device)
        self.backend = str(dist.get_backend())
        self.rank = dist.get_rank()
        names = list(self.shape)
        strides, s = {}, 1
        for name in reversed(names):
            strides[name] = s
            s *= self.shape[name]
        self.coords = {name: (self.rank // strides[name]) % self.shape[name] for name in names}
        self.groups, self.ranks = {}, {}
        timeout = _timeout()
        # every rank creates every group, in one order (new_group's rule)
        for name in names:
            for base in range(world):
                if (base // strides[name]) % self.shape[name]:
                    continue  # not the first rank of its line along `name`
                line = [base + i * strides[name] for i in range(self.shape[name])]
                group = dist.new_group(line, timeout=timeout)
                if self.rank in line:
                    self.groups[name], self.ranks[name] = group, line
        self.world = dist.new_group(list(range(world)), timeout=timeout)
        if self.stages_on_host() and "gloo" not in _announced:
            _announced.add("gloo")
            print("mesh: gloo carries CUDA tensors for all_reduce and broadcast; point-to-point "
                  "and gathers stage them through host memory", flush=True)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def stages_on_host(self) -> bool:
        """Whether gathers and point-to-point go through host memory: gloo
        over CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def bind_thread(self) -> None:
        """Make this rank's card current in the calling thread (a service's
        scheduler thread enters collectives too)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.backend})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
              device="cuda") -> Mesh:
    """A ('dp', 'tp') mesh over every rank of the process group (started
    from torchrun's environment when none is running). n_devices, when
    given, must be the group's size; dp defaults to size / tp."""
    init_distributed(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the process group has {n} ranks")
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks are not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != ranks({n})")
    return Mesh({"dp": dp, "tp": tp}, device)


def as_mesh(mesh) -> Mesh:
    """`mesh` itself when it is a Mesh; TypeError for anything else."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh


# ---------------------------------------------------------------------- #
# transport
# ---------------------------------------------------------------------- #

def _global(mesh: Mesh, axis: str, index: int) -> int:
    return mesh.ranks[axis][index] if axis != "world" else index


def _group(mesh: Mesh, axis: str):
    return mesh.world if axis == "world" else mesh.groups[axis]


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`) `t` in place over the ranks of `axis`."""
    if mesh.size(axis) > 1 or axis == "world":
        dist.all_reduce(t, op=op, group=_group(mesh, axis))
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh, axis: str = "world", src: int = 0) -> torch.Tensor:
    """`t` in place from the rank at index `src` of `axis` to the others."""
    dist.broadcast(t, src=_global(mesh, axis, src), group=_group(mesh, axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str):
    """Every rank's `t` along `axis`, in axis order (equal shapes)."""
    if mesh.size(axis) == 1:
        return [t]
    src = t.contiguous()
    host = mesh.stages_on_host() and src.is_cuda
    if host:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(out, src, group=_group(mesh, axis))
    return [o.to(t.device) for o in out] if host else out


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The `t` of the previous rank on `axis` (this rank's goes to the next)."""
    n = mesh.size(axis)
    if n == 1:
        return t
    i = mesh.coord(axis)
    src = t.contiguous()
    host = mesh.stages_on_host() and src.is_cuda
    if host:
        src = src.cpu()
    dst = torch.empty_like(src)
    group = _group(mesh, axis)
    ops = [dist.P2POp(dist.isend, src, _global(mesh, axis, (i + 1) % n), group),
           dist.P2POp(dist.irecv, dst, _global(mesh, axis, (i - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return dst.to(t.device) if host else dst


def send(t: torch.Tensor, mesh: Mesh, axis: str, to: int):
    """Start sending `t` to index `to` of `axis`; returns (request, buffer):
    wait on the request before the buffer may change."""
    src = t.contiguous()
    if mesh.stages_on_host() and src.is_cuda:
        src = src.cpu()
    return dist.isend(src, _global(mesh, axis, to), group=_group(mesh, axis)), src


def recv(like: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """A tensor shaped like `like` from index `src` of `axis` (blocking)."""
    host = mesh.stages_on_host() and like.is_cuda
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
    dist.recv(buf, _global(mesh, axis, src), group=_group(mesh, axis))
    return buf.to(like.device) if host else buf


def _to_host(obj):
    if torch.is_tensor(obj):
        # a copy of its own: a pickled view would carry its whole storage
        t = obj.detach()
        return t.cpu() if t.is_cuda else t.clone()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return type(obj)(**{k: _to_host(getattr(obj, k)) for k in obj.__dataclass_fields__})
    return obj


def to_device(obj, device):
    """`obj` (tensors inside dicts, lists, tuples and dataclasses) with its
    tensors moved to `device`."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return type(obj)(**{k: to_device(getattr(obj, k), device)
                            for k in obj.__dataclass_fields__})
    return obj


def gather_objects(obj, mesh: Mesh, axis: str) -> list:
    """Every rank's `obj` along `axis`, in axis order, its tensors on this
    rank's device. Objects travel pickled with their tensors on the host,
    so a rank never receives another card's tensors."""
    out = [None] * mesh.size(axis)
    dist.all_gather_object(out, _to_host(obj), group=_group(mesh, axis))
    return [to_device(o, mesh.device) for o in out]


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's `obj` on every rank of the mesh (others pass anything),
    pickled with its tensors on the host."""
    box = [_to_host(obj) if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.world,
                               device=mesh.device if mesh.backend == "nccl" else None)
    return to_device(box[0], mesh.device)


# ---------------------------------------------------------------------- #
# batch and parameter placement
# ---------------------------------------------------------------------- #

def dp_slice(n: int, mesh: Mesh) -> slice:
    """This rank's rows of n split evenly over dp (n divisible by dp)."""
    dp = mesh.size("dp")
    if n % dp:
        raise ValueError(f"batch size {n} not divisible by dp={dp}; use a batch size that "
                         f"is a multiple of the mesh's dp axis")
    per = n // dp
    return slice(mesh.coord("dp") * per, (mesh.coord("dp") + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's dp slice of the leading axis of every array in `batch`
    (a tensor, numpy array, or dict / list / tuple of them)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[dp_slice(batch.shape[0], mesh)]


def replicate_params(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` overwritten, in place, with
    rank 0's (the SPMD counterpart of replicating over the mesh)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, mesh)
    return module


# ---------------------------------------------------------------------- #
# TL-TR split rules (`_tltr_param_spec` of the JAX package)
# ---------------------------------------------------------------------- #

_COLUMN = ("attn.query.", "attn.key.", "attn.value.", "mlp.0.")
_ROW = ("attn.out.weight", "mlp.2.weight")


def tltr_split_dim(name: str, ndim: int) -> Optional[int]:
    """The axis of a TL-TR parameter (torch [out, in] layout) split over tp:
    0 for the query, key, value and fc1 weights and their biases (the
    output dimension), 1 for the out and fc2 weights (the input
    dimension), None (replicated) for everything else."""
    if any(k in name for k in _COLUMN) and ndim in (1, 2):
        return 0
    if ndim == 2 and name.endswith(_ROW):
        return 1
    return None


def tltr_param_shardings(model) -> Dict[str, Optional[int]]:
    """{parameter name: split axis or None} of a TL-TR head (`tltr_split_dim`)."""
    return {name: tltr_split_dim(name, p.dim()) for name, p in model.named_parameters()}


def split_rows(t: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    """Part `index` of `size` equal parts of `t` along `dim`, as its own tensor."""
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} is not divisible by {size}")
    return t.narrow(dim, index * (n // size), n // size).clone()


__all__ = [
    "Mesh", "all_gather", "all_reduce_", "as_mesh", "broadcast_", "broadcast_object",
    "dp_slice", "gather_objects", "init_distributed", "local_device", "make_mesh", "recv",
    "replicate_params", "ring_shift", "send", "shard_batch", "split_rows",
    "tltr_param_shardings", "tltr_split_dim", "to_device",
]
