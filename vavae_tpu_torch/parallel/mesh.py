"""Process groups, the (data, fsdp, tensor) mesh and the collectives
(port of ``vavae_tpu/parallel/mesh.py`` onto ``torch.distributed``).

One process drives one card. ``multihost_init`` joins the world from the
launcher's environment: torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` (the reference's
``run_train.sh`` contract), or the JAX package's
``JAX_COORDINATOR_ADDRESS`` (host:port), ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``, so one launcher drives both packages. NCCL on the
card, gloo when the caller asks for the CPU.

``make_mesh`` lays the ranks out as JAX lays out its devices: a
(data, fsdp, tensor) array with ``tensor`` innermost, ``data=None`` taking
the rest. Every axis, and the batch axis data × fsdp (``dp``), has its own
process group, each created with an explicit timeout; FSDP2 gets a
``DeviceMesh`` built over those groups. Without a process group the mesh is
a single process and every collective is the identity.

Not ported, since XLA alone has them: ``donation_supported`` and
``donate_state_argnums`` (buffer donation; the port's trainers update their
state in place), ``cpu_mesh`` (XLA's forced host devices; the port tests
worlds of processes over gloo) and ``local_mesh_if_divisible`` (a mesh of
one process's local devices; a process of the port drives one card).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
DP = "dp"  # the batch axis: data × fsdp, as JAX's P((data, fsdp))

DEFAULT_TIMEOUT_S = 1800.0


def _timeout() -> datetime.timedelta:
    """Every process group's timeout: ``VAVAE_DIST_TIMEOUT`` seconds, 30
    minutes by default."""
    return datetime.timedelta(seconds=float(os.environ.get("VAVAE_DIST_TIMEOUT",
                                                           DEFAULT_TIMEOUT_S)))


def launch_env() -> Optional[dict]:
    """The world the environment names, as {rank, world_size, local_rank,
    addr, port}, or None when it names none. torchrun's variables win over
    the JAX package's."""
    if "RANK" in os.environ or "WORLD_SIZE" in os.environ:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"the environment names a world but lacks {missing}")
        rank = int(os.environ["RANK"])
        return {"rank": rank, "world_size": int(os.environ["WORLD_SIZE"]),
                "local_rank": int(os.environ.get("LOCAL_RANK", rank)),
                "addr": os.environ["MASTER_ADDR"], "port": int(os.environ["MASTER_PORT"])}
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return None
    host, _, port = addr.rpartition(":")
    if not host or "JAX_NUM_PROCESSES" not in os.environ or "JAX_PROCESS_ID" not in os.environ:
        raise RuntimeError("JAX_COORDINATOR_ADDRESS needs host:port, JAX_NUM_PROCESSES and "
                           "JAX_PROCESS_ID (the port has no cluster auto-detection)")
    rank = int(os.environ["JAX_PROCESS_ID"])
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        local = rank % max(n, 1)
    return {"rank": rank, "world_size": int(os.environ["JAX_NUM_PROCESSES"]),
            "local_rank": int(local), "addr": host, "port": int(port)}


def multihost_init(device: str | torch.device = "cuda") -> torch.device:
    """Join the world the environment names (see ``launch_env``) and
    return this process's device: ``cuda:LOCAL_RANK`` (set as the current
    device first) over NCCL, or the CPU over gloo when ``device`` is the
    CPU. Does nothing beyond resolving ``device`` when no world is named or
    the process group exists already. Asking for CUDA without a card
    raises; a named world never falls back to a single process."""
    dev = torch.device(device)
    env = launch_env()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if env is None and not dist.is_initialized():
        return dev
    local_rank = env["local_rank"] if env else (torch.cuda.current_device()
                                                 if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw: dict[str, Any] = {}
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(
            backend, init_method=f"tcp://{env['addr']}:{env['port']}",
            world_size=env["world_size"], rank=env["rank"], timeout=_timeout(), **kw)
    return dev


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_fname(prefix: str, suffix: str, shard: int) -> str:
    """Per-process shard file name, the JAX package's (and the reference's
    ``extract_features.py:115``): ``{prefix}_rank{idx:02d}_shard{k:03d}{suffix}``."""
    return f"{prefix}_rank{process_index():02d}_shard{shard:03d}{suffix}"


def _comm_device() -> torch.device:
    """Where a host value travels for a collective: the current card under
    NCCL, the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass
class Mesh:
    """This process's place in the (data, fsdp, tensor) layout and the
    process group of each axis (None for a single process)."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]
    _device_meshes: dict = dataclasses.field(default_factory=dict)

    def size(self, axis: str) -> int:
        if axis == DP:
            return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]
        return self.shape[axis]

    def index(self, axis: str) -> int:
        if axis == DP:
            return self.coords[DATA_AXIS] * self.shape[FSDP_AXIS] + self.coords[FSDP_AXIS]
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    @property
    def distributed(self) -> bool:
        return bool(self.groups)

    def device_mesh(self, axes: Sequence[str], device_type: str):
        """A ``DeviceMesh`` over ``axes`` built on this mesh's groups (their
        timeouts kept), for FSDP2."""
        key = (tuple(axes), device_type)
        if key not in self._device_meshes:
            from torch.distributed.device_mesh import DeviceMesh

            ranks = _rank_array(self.shape)
            index = tuple(slice(None) if a in axes else self.coords[a] for a in AXES)
            sub = torch.as_tensor(ranks[index])
            groups = [self.groups[a] for a in axes]
            self._device_meshes[key] = DeviceMesh.from_group(
                groups[0] if len(groups) == 1 else groups, device_type,
                mesh=sub, mesh_dim_names=tuple(axes))
        return self._device_meshes[key]


def _rank_array(shape: dict[str, int]) -> np.ndarray:
    return np.arange(int(np.prod([shape[a] for a in AXES]))).reshape(
        [shape[a] for a in AXES])


def make_mesh(data: Optional[int] = None, fsdp: int = 1, tensor: int = 1) -> Mesh:
    """The (data, fsdp, tensor) mesh over the world's processes, ``tensor``
    innermost. ``data=None`` (the config's ``data: -1``) takes what fsdp
    and tensor leave; a product that is not the world size is an error.
    Collective: every process calls it with the same sizes."""
    n = process_count()
    if data is None:
        if n % (fsdp * tensor):
            raise ValueError(f"world of {n} does not divide fsdp {fsdp} × tensor {tensor}")
        data = n // (fsdp * tensor)
    if data * fsdp * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} processes")
    shape = {DATA_AXIS: data, FSDP_AXIS: fsdp, TENSOR_AXIS: tensor}
    ranks = _rank_array(shape)
    me = process_index()
    coords = dict(zip(AXES, (int(c) for c in np.argwhere(ranks == me)[0])))
    groups: dict[str, Any] = {}
    if dist.is_initialized():
        # every process creates every group, in one order
        layouts = {a: np.moveaxis(ranks, i, -1).reshape(-1, shape[a]) for i, a in enumerate(AXES)}
        layouts[DP] = np.moveaxis(ranks, 2, 0).reshape(tensor, data * fsdp)
        for axis, rows in layouts.items():
            for row in rows:
                g = dist.new_group([int(r) for r in row], timeout=_timeout())
                if me in row:
                    groups[axis] = g
    return Mesh(shape=shape, coords=coords, groups=groups)


def mesh_from_config(par) -> Mesh:
    """``make_mesh`` from a config's ``parallel:`` block (``data: -1`` takes
    the rest)."""
    par = par or {}
    data = par.get("data", -1)
    return make_mesh(data=data if data and data > 0 else None,
                     fsdp=par.get("fsdp", 1), tensor=par.get("tensor", 1))


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a global batch (a tensor, an array or a
    tuple/list/dict of them): the batch axis is split over data × fsdp,
    as JAX's ``data_sharding``; tensor-parallel ranks share their rows."""
    n, i = mesh.size(DP), mesh.index(DP)

    def rows(x):
        if len(x) % n:
            raise ValueError(f"batch of {len(x)} does not split over {n} data ranks")
        b = len(x) // n
        return x[i * b:(i + 1) * b]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(rows(x) for x in batch)
    return rows(batch)


# -- collectives -------------------------------------------------------------------


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _all_reduce_flat_(tensors: Sequence[torch.Tensor], group, mean: bool) -> None:
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat.div_(_size(group))
    off = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[off:off + k].view(t.shape))
        off += k


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over ``group``, in place, through one
    flat fp32 bucket (one collective): the sum, then a division by the
    group's size. The identity without a process group."""
    _all_reduce_flat_(tensors, group, mean=True)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """``all_reduce_mean_`` without the division."""
    _all_reduce_flat_(tensors, group, mean=False)


def process_allgather(x, group=None) -> np.ndarray:
    """Every process's ``x`` (equal shapes), stacked on a new leading axis,
    on every process (``multihost_utils.process_allgather``)."""
    a = np.asarray(x)
    if not dist.is_initialized():
        return a[None]
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(out, t, group=group)
    return np.stack([o.cpu().numpy() for o in out])


def all_gather_rows(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` in ``group``, whose leading dims may differ by
    rank (a padded all-gather, trimmed again)."""
    if not dist.is_initialized() or _size(group) == 1:
        return [t]
    n = _size(group)
    lens = torch.tensor([t.shape[0]], device=t.device, dtype=torch.int64)
    all_lens = [torch.empty_like(lens) for _ in range(n)]
    dist.all_gather(all_lens, lens, group=group)
    lens_i = [int(x) for x in all_lens]
    top = max(lens_i)
    pad = t.new_zeros((top,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    out = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(out, pad.contiguous(), group=group)
    return [o[:k] for o, k in zip(out, lens_i)]


def all_gather_cat(t: torch.Tensor, group, grad: bool = False) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) of ``group``, concatenated on dim 0
    in rank order; with ``grad`` through the differentiable all-gather (its
    backward sums each rank's gradient into the rank that gave the rows).
    ``t`` itself without a process group."""
    if not dist.is_initialized():
        return t
    if grad:
        from torch.distributed.nn.functional import all_gather

        return torch.cat(all_gather(t, group=group))
    out = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)


_HOST_GROUP: list = []  # [the gloo group of host flags], made at first use


def any_process(flag: bool) -> bool:
    """Whether ``flag`` is true on any process, on every process: a max
    all-reduce of one value over a gloo group, so it waits on no card's
    queue. Collective: every process calls it at the same point. ``flag``
    itself without a process group."""
    if not dist.is_initialized():
        return bool(flag)
    if not _HOST_GROUP:
        _HOST_GROUP.append(None if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo", timeout=_timeout()))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP[0])
    return bool(t.item())


def barrier() -> None:
    """Wait for every process (``multihost_utils.sync_global_devices``)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the world, if joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP.clear()
