"""Device meshes, named-axis sharding rules and the mesh's collectives.

Port of ``llm_d_fast_model_actuation_tpu/parallel/mesh.py``. There the
mesh is declarative: tensors carry logical axis names, the rules map
them to mesh axes, and XLA's partitioner derives every slice and inserts
every collective. PyTorch has no such partitioner, so the port keeps the
same tables (``AXES``, ``LOGICAL_RULES``, the per-weight logical axes in
``models/llama.py:param_logical_axes``) and writes out by hand what the
partitioner derives from them: :func:`spec_for` answers "which mesh axis
splits each dimension of this weight", :func:`shard_for` cuts a rank's
slice, and :class:`Mesh` carries the collectives.

All five axes are realised in one process: ``dp``, ``pp``, ``sp``,
``tp`` and ``ep`` (a gang's mesh, below, refuses ``pp``). A rank is an
index into an ordered list of devices,
**and a device may appear more than once**: ranks on one card run every
line of the sharded path except the copy between cards, which is how a
one-card machine (and the CPU tests, mesh ``cpu,cpu``) exercises it.
Ranks take their coordinates in ``AXES`` order, the row-major reshape of
the device list (``ep`` innermost), as the reference's ``make_mesh``
lays out a flat device list.

``pp`` is STAGES, what the reference's docstring names it ("lax.scan
over stages + ppermute"): the ranks at ``pp`` coordinate ``s`` hold
layers ``[s * L / pp, (s + 1) * L / pp)`` of every layer stack (its
``"layers": "pp"`` rule, :func:`stage_layers`), a forward runs stage
after stage, each on the stage's own mesh of the other four axes
(:meth:`Mesh.stage_mesh`), and the residual stream goes from the last
layer of stage ``s`` to the first of stage ``s + 1`` (:meth:`Mesh.
hand_off`, the reference's ``ppermute`` along ``pp``). The bytes each
rank holds are what the reference's ``pp`` sharding puts on its device,
and each layer runs the same kernels at the same shapes as on one rank.

One process drives every rank (the reference's single-process mesh), or
a GANG of processes drives them together (``group``, a
``torch.distributed`` process group: the reference's multi-host mesh
over ``jax.distributed``, ``engine/multihost.py``). In a gang the global
device list is each process's local devices in process order, process
``p`` holds ranks ``[p * L, (p + 1) * L)``, and a per-rank list carries
``None`` for a rank of another process (:meth:`Mesh.per_rank`).

The collectives are plain functions on a list of per-rank tensors over
one named axis or a set of axes: the groups of ranks that share every
other coordinate. They are deterministic (a fixed rank order, so a run
repeats bit for bit) and move bytes as copies through the group's first
rank. They are also differentiable: plain tensor ops (``+``, ``.to``,
``cat``) with no in-place write into a shared result and no
``torch.no_grad``, so autograd carries their transposes as ``jax.grad``
carries those of ``psum`` and ``ppermute`` (the all-reduce's transpose
is an all-reduce, the ring shift's the shift the other way).

Across a gang's processes a collective moves BYTES only: each process's
tensors are viewed as ``uint8``, staged through host memory and
exchanged over the group (Gloo), which never does the arithmetic; every
process then adds the same gathered partials in the same rank order and
dtype as the one-process mesh, so a gang is bit-equal to the one-process
mesh of the same plan. NCCL is not the transport: it refuses two ranks of
one communicator on one device, and a gang rehearsed on one card puts
both of its processes there (``chip_smoke.py``'s ``gang`` phase). The
exchange is not differentiable (a gang serves; it does not train).

Streams: a rank's work goes to its device's current stream; the ranks
have no streams of their own. Ranks on two cards run side by side as it
is, each card has its own queue, and PyTorch orders a copy between cards
after both cards' current streams, so the collectives need no event of
their own. Ranks that share one card serialise on its queue. A stream per
rank was tried there (NVIDIA H100, ``chip_smoke.py``): the two ranks'
ragged launches then overlap (0.90-0.98 ms for both against 1.23 ms in
series at 256 rows), but a serving step is bound by the host's launches
and got no faster (decode 79-135 ms a token with the streams, 85-115 ms
without), so the streams, their events and the allocator's cross-stream
bookkeeping went again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

AXES = ("dp", "pp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshPlan:
    """Degrees of each parallelism axis. Product must equal device count."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp, self.ep)

    def describe(self) -> str:
        return ",".join(
            f"{n}={v}" for n, v in zip(AXES, self.axis_sizes()) if v > 1
        ) or "single-device"


# Logical axis name -> mesh axis: the reference's table, unchanged.
LOGICAL_RULES: Dict[Any, Any] = {
    "batch": "dp",
    "seq": "sp",
    "embed": None,  # replicated over tp (activations)
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": "pp",
    "expert": "ep",
    "kv_batch": "dp",
    None: None,
}


def spec_for(
    logical_axes: Sequence[Optional[str]], rules: Optional[Dict[Any, Any]] = None
) -> Tuple[Optional[str], ...]:
    """Logical axis names -> the mesh axis of each dimension (None =
    replicated), via the rules table: the reference's ``PartitionSpec``
    as a plain tuple."""
    rules = rules or LOGICAL_RULES
    return tuple(rules.get(ax) for ax in logical_axes)


def shard(x, dim: Optional[int], rank: int, tp: int):
    """Rank ``rank``'s slice of ``x`` (a tensor or a numpy array) along
    ``dim``: the ``rank``-th of ``tp`` equal contiguous pieces, as
    ``NamedSharding`` cuts them. ``dim`` None returns ``x`` whole."""
    if dim is None:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"dimension {dim} of size {n} is not divisible by tp={tp}")
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(rank * (n // tp), (rank + 1) * (n // tp))
    return x[tuple(index)]


def plan_for_devices(
    n: int, tp: Optional[int] = None, sp: int = 1, pp: int = 1, ep: int = 1
) -> MeshPlan:
    """Choose a plan for ``n`` devices: given tp (default the largest of
    8, 4, 2, 1 that divides n), the rest goes to dp."""
    if tp is None:
        tp = next(c for c in (8, 4, 2, 1) if c <= n and n % c == 0)
    inner = tp * sp * pp * ep
    if n % inner != 0:
        raise ValueError(f"{n} devices not divisible by tp*sp*pp*ep={inner}")
    return MeshPlan(dp=n // inner, pp=pp, sp=sp, tp=tp, ep=ep)


PerRank = List[torch.Tensor]
AxisNames = Union[str, Sequence[str]]


def _axis_tuple(axes: AxisNames) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; axes are {AXES}")
    return names


class Mesh:
    """An ordered list of devices, one per rank (a device may repeat),
    laid out as ``plan``'s five axes, and the collectives over them.
    ``shape`` maps each axis to its size, as the reference's
    ``Mesh.shape`` does. ``group`` (a ``torch.distributed`` process
    group, Gloo) makes it a gang's mesh: ``devices`` is then the GLOBAL
    list, and this process holds the ranks of :attr:`local_ranks`."""

    def __init__(
        self, plan: MeshPlan, devices: Sequence[Union[str, torch.device]], group: Any = None
    ) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if plan.size != len(devices):
            raise ValueError(f"mesh plan {plan} needs {plan.size} devices, have {len(devices)}")
        self.plan = plan
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        for d in self.devices:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
        # an index on every CUDA device, so two spellings of one card compare equal
        self.devices = [
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in self.devices
        ]
        self.shape: Dict[str, int] = dict(zip(AXES, plan.axis_sizes()))
        # row-major coordinates in AXES order, the last axis fastest
        self._coords: List[Tuple[int, ...]] = []
        for r in range(plan.size):
            c, rest = [], r
            for n in reversed(plan.axis_sizes()):
                c.append(rest % n)
                rest //= n
            self._coords.append(tuple(reversed(c)))
        self._groups: Dict[Tuple[str, ...], List[List[int]]] = {}
        self._stages: Dict[int, "Mesh"] = {}
        #: the gang's process group, or None for one process
        self.process_group = group
        self.num_processes, self.process_index = 1, 0
        if group is not None:
            import torch.distributed as dist

            self.num_processes, self.process_index = dist.get_world_size(group), dist.get_rank(group)
            if plan.size % self.num_processes:
                raise ValueError(f"{plan.size} ranks do not divide over {self.num_processes} processes")
        per = plan.size // self.num_processes
        #: the ranks this process holds, in rank order
        self.local_ranks: List[int] = list(range(self.process_index * per, (self.process_index + 1) * per))
        self._local = set(self.local_ranks)
        #: the cross-process exchanges: count, bytes sent and received
        #: through host memory, seconds inside the group's calls and
        #: seconds staging between the devices and host memory (the
        #: latter waits for the work queued before the exchange)
        self.exchange_stats: Dict[str, float] = {"exchanges": 0, "bytes": 0, "gloo_s": 0.0, "stage_s": 0.0}

    @property
    def size(self) -> int:
        """The number of ranks."""
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.plan.tp

    @property
    def spans_processes(self) -> bool:
        """Whether the ranks are held by more than one process (a gang)."""
        return self.num_processes > 1

    def is_local(self, rank: int) -> bool:
        """Whether this process holds ``rank``."""
        return rank in self._local

    def per_rank(self, fn) -> List[Any]:
        """``fn(rank)`` for each rank this process holds, in rank order,
        and None for every other rank."""
        return [fn(r) if r in self._local else None for r in range(self.size)]

    def distinct_devices(self) -> List[torch.device]:
        """This process's devices, each once, in rank order (every device
        of a one-process mesh)."""
        return list(dict.fromkeys(self.devices[r] for r in self.local_ranks))

    def __repr__(self) -> str:
        gang = f", process {self.process_index} of {self.num_processes}" if self.spans_processes else ""
        return f"Mesh({self.plan.describe()}: {[str(d) for d in self.devices]}{gang})"

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on every axis."""
        return dict(zip(AXES, self._coords[rank]))

    def index(self, rank: int, axis: str) -> int:
        """Rank ``rank``'s coordinate on ``axis`` (the reference's
        ``jax.lax.axis_index`` inside a ``shard_map``)."""
        return self._coords[rank][AXES.index(axis)]

    def groups(self, axes: AxisNames) -> List[List[int]]:
        """The ranks that share every coordinate off ``axes``, one list per
        group, each ordered by its coordinates on ``axes`` (row-major in
        ``AXES`` order), the groups by their first rank."""
        key = _axis_tuple(axes)
        if key not in self._groups:  # every collective asks: computed once an axis set
            on = [AXES.index(a) for a in key]
            out: Dict[Tuple[int, ...], List[int]] = {}
            for r, c in enumerate(self._coords):
                out.setdefault(tuple(v for i, v in enumerate(c) if i not in on), []).append(r)
            self._groups[key] = list(out.values())
        return self._groups[key]

    def group(self, rank: int, axes: AxisNames) -> List[int]:
        """The group of :meth:`groups` that holds ``rank``."""
        return next(g for g in self.groups(axes) if rank in g)

    # -- pipeline stages ------------------------------------------------------

    @property
    def pp(self) -> int:
        return self.plan.pp

    def stage(self, rank: int) -> int:
        """The pipeline stage of ``rank``: its ``pp`` coordinate."""
        return self.index(rank, "pp")

    def stage_ranks(self, stage: int) -> List[int]:
        """The ranks of ``stage``, in rank order: row-major over the other
        four axes, so the ``j``-th rank of every stage has the same
        coordinates off ``pp``."""
        return [r for r in range(self.size) if self.stage(r) == stage]

    def stage_mesh(self, stage: int) -> "Mesh":
        """The mesh of ``stage``'s ranks over the other four axes (``pp``
        1): its rank ``j`` is ``stage_ranks(stage)[j]``, so every
        collective inside a stage runs on it unchanged. Without ``pp`` the
        mesh itself."""
        if self.pp == 1:
            return self
        if self.spans_processes:
            raise NotImplementedError("pipeline stages across a gang's processes (ROADMAP.md queue 1 item 15)")
        if stage not in self._stages:
            p = self.plan
            self._stages[stage] = Mesh(
                MeshPlan(dp=p.dp, sp=p.sp, tp=p.tp, ep=p.ep), [self.devices[r] for r in self.stage_ranks(stage)]
            )
        return self._stages[stage]

    def hand_off(self, parts: Sequence[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        """The pipeline's hand-off, the reference's ``ppermute`` along
        ``pp`` with ``[(i, i + 1)]``: the rank at stage ``s`` gives its
        tensor to the rank with the same coordinates at stage ``s + 1``, a
        copy when their devices differ (the same tensor when they share
        one). The first stage's ranks get None and the last stage's
        tensors go nowhere. Differentiable: the transpose is the hand-off
        the other way."""
        self._check(parts)
        if self.spans_processes:
            raise NotImplementedError("pipeline stages across a gang's processes (ROADMAP.md queue 1 item 15)")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for g in self.groups("pp"):
            for src, dst in zip(g, g[1:]):
                out[dst] = None if parts[src] is None else parts[src].to(self.devices[dst])
        return out

    # -- replicated inputs ----------------------------------------------------

    def replicate(self, x: "torch.Tensor | Sequence[torch.Tensor]") -> PerRank:
        """One tensor per rank holding ``x``: ranks on ``x``'s own device
        share it, every other device gets one copy (in a gang, every rank
        of this process; the others are None, their process holds the
        same ``x``). A per-rank list is taken as given."""
        if not isinstance(x, torch.Tensor):
            self._check(x)
            return list(x)
        copies = {x.device: x}
        for d in self.distinct_devices():
            if d not in copies:
                copies[d] = x.to(d)
        return self.per_rank(lambda r: copies[self.devices[r]])

    # -- collectives ----------------------------------------------------------

    def _check(self, parts: Sequence[torch.Tensor]) -> None:
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} per-rank tensors for a mesh of {self.size}")

    def _home(self, g: List[int]) -> torch.device:
        """Where a group's result is formed on this process: the group's
        first rank's device when this process holds it, else the device of
        its first rank here."""
        return self.devices[next(r for r in g if r in self._local)]

    def _exchange(self, parts: Sequence[Optional[torch.Tensor]], ranks: Sequence[int], to_first: bool = False):
        """The tensors of ``ranks`` on this process: its own as given, every
        other process's received as bytes. Each process sends its ranks'
        tensors of ``ranks`` (in rank order, as ``uint8`` in host memory)
        to all the others, or with ``to_first`` to process 0 alone (the
        others then get only their own). Every tensor of ``ranks`` has the
        shape and dtype of this process's first one (the collectives' parts
        are equal shards). A failed exchange raises."""
        import time

        import torch.distributed as dist

        out: Dict[int, torch.Tensor] = {r: parts[r] for r in ranks if r in self._local}
        mine = [out[r] for r in sorted(out)]
        if not mine:
            raise ValueError(f"process {self.process_index} holds none of ranks {list(ranks)}")
        like = mine[0]
        for t in mine:
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError("a collective across processes needs parts of one shape and dtype")
        owners = [[r for r in ranks if r // len(self.local_ranks) == p] for p in range(self.num_processes)]
        if len({len(o) for o in owners}) != 1:
            raise ValueError(f"ranks {list(ranks)} are not spread evenly over {self.num_processes} processes")
        st = self.exchange_stats
        t0 = time.perf_counter()
        send = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in mine]).cpu()
        t1 = time.perf_counter()
        if to_first:
            got = [torch.empty_like(send) for _ in range(self.num_processes)] if self.process_index == 0 else None
            dist.gather(send, got, dst=dist.get_global_rank(self.process_group, 0), group=self.process_group)
        else:
            got = [torch.empty_like(send) for _ in range(self.num_processes)]
            dist.all_gather(got, send, group=self.process_group)
        t2 = time.perf_counter()
        moved = send.numel()
        if got is not None:
            per = like.numel() * like.element_size()
            home = like.device
            for p, held in enumerate(owners):
                if p == self.process_index:
                    continue
                moved += got[p].numel()
                buf = got[p].to(home)
                for i, r in enumerate(held):
                    out[r] = buf[i * per:(i + 1) * per].view(like.dtype).reshape(like.shape)
        t3 = time.perf_counter()
        st["exchanges"] += 1
        st["bytes"] += moved
        st["gloo_s"] += t2 - t1
        st["stage_s"] += (t1 - t0) + (t3 - t2)
        return out

    def all_reduce_sum(self, parts: Sequence[torch.Tensor], axes: AxisNames = "tp") -> PerRank:
        """The sum of the partials over each group of ``axes``, on every
        rank of the group. Each partial is brought to the group's first
        rank's device, added there in rank order in the tensors' own dtype
        (bf16 partials give a bf16 sum, as the reference's partitioner
        reduces the bf16 product), and the sum copied back to each rank;
        ranks on that device share the one sum tensor (the copies vanish),
        so nobody may write into it. Deterministic: the order never
        changes. In a gang every process forms the sums of its own ranks'
        groups from every partial's bytes, in the same order and dtype."""
        self._check(parts)
        out: List[Any] = list(parts)
        if self.spans_processes:
            multi = [g for g in self.groups(axes) if len(g) > 1]
            got = self._exchange(parts, [r for g in multi for r in g]) if multi else {}
            for g in multi:
                home = self._home(g)
                total = got[g[0]].to(home)
                for r in g[1:]:
                    total = total + got[r].to(home)
                for r in g:
                    if r in self._local:
                        out[r] = total.to(self.devices[r])
            return out
        for g in self.groups(axes):
            if len(g) == 1:
                continue
            home = self.devices[g[0]]
            total = parts[g[0]]
            for r in g[1:]:
                total = total + parts[r].to(home)
            for r in g:
                out[r] = total.to(self.devices[r])
        return out

    def gather(self, parts: Sequence[torch.Tensor], dim: int, axes: AxisNames = "tp") -> Optional[torch.Tensor]:
        """Rank 0's group's slices joined along ``dim`` in rank order, on
        rank 0 only (where sampling runs); in a gang, None on every process
        but rank 0's, whose slices go to it as bytes."""
        self._check(parts)
        g = self.group(0, axes)
        if len(g) == 1:
            return parts[0]
        if self.spans_processes:
            got = self._exchange(parts, g, to_first=True)
            if not self.is_local(0):
                return None
            return torch.cat([got[r].to(self.devices[0]) for r in g], dim=dim)
        return torch.cat([parts[r].to(self.devices[0]) for r in g], dim=dim)

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int, axes: AxisNames = "tp") -> PerRank:
        """Each group's slices joined along ``dim`` in rank order, on every
        rank of the group."""
        self._check(parts)
        out: List[Any] = list(parts)
        multi = [g for g in self.groups(axes) if len(g) > 1]
        got = self._exchange(parts, [r for g in multi for r in g]) if self.spans_processes and multi else parts
        for g in multi:
            home = self._home(g)
            whole = torch.cat([got[r].to(home) for r in g], dim=dim)
            for r in g:
                if r in self._local:
                    out[r] = whole.to(self.devices[r])
        return out

    def ring_shift(self, parts: Sequence[torch.Tensor], axis: str) -> PerRank:
        """The reference's ``ppermute`` with ``[(i, (i + 1) % n)]``: along
        ``axis``, the rank at coordinate i hands its tensor to the rank at
        i + 1 mod n, so each rank ends with its predecessor's."""
        self._check(parts)
        out: List[Any] = list(parts)
        groups = self.groups(axis)
        got = self._exchange(parts, [r for g in groups for r in g]) if self.spans_processes else parts
        for g in groups:
            n = len(g)
            for i, r in enumerate(g):
                dst = g[(i + 1) % n]
                if dst in self._local:
                    out[dst] = got[r].to(self.devices[dst])
        return out

    def broadcast(self, x: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on this process: in a gang the process holding
        rank 0 sends its bytes, and every other process receives them into
        a tensor of ``like``'s shape and dtype on ``like``'s device (its
        ``x`` is ignored); on one process, ``x`` itself."""
        if not self.spans_processes:
            return x
        import time

        import torch.distributed as dist

        t0 = time.perf_counter()
        if self.is_local(0):
            buf = x.to(like.dtype).contiguous().reshape(-1).view(torch.uint8).cpu()
        else:
            buf = torch.empty(like.numel() * like.element_size(), dtype=torch.uint8)
        t1 = time.perf_counter()
        dist.broadcast(buf, src=dist.get_global_rank(self.process_group, 0), group=self.process_group)
        t2 = time.perf_counter()
        out = x if self.is_local(0) else buf.to(like.device).view(like.dtype).reshape(like.shape)
        st = self.exchange_stats
        st["exchanges"] += 1
        st["bytes"] += buf.numel()
        st["gloo_s"] += t2 - t1
        st["stage_s"] += (t1 - t0) + (time.perf_counter() - t2)
        return out


def shard_for(x, spec: Sequence[Optional[str]], mesh: Optional[Mesh], rank: int):
    """Rank ``rank``'s slice of ``x`` (a tensor or a numpy array) under
    ``spec`` (a mesh axis or None per dimension, :func:`spec_for`): each
    split dimension cut into its axis' size of equal contiguous pieces,
    the piece at the rank's coordinate on that axis, as ``NamedSharding``
    cuts them. No mesh, or a spec of Nones, returns ``x`` whole. A spec
    that splits two dimensions over one axis raises, as a
    ``PartitionSpec`` does."""
    named = [a for a in spec if a is not None]
    if len(named) != len(set(named)):
        raise ValueError(f"{tuple(spec)} splits more than one dimension over one mesh axis")
    if mesh is None:
        return x
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape[axis] > 1:
            x = shard(x, dim, mesh.index(rank, axis), mesh.shape[axis])
    return x


def join_for(parts: Sequence[torch.Tensor], spec: Sequence[Optional[str]], mesh: Mesh) -> torch.Tensor:
    """The inverse of :func:`shard_for`: the whole tensor from the ranks'
    slices ``parts`` (one per rank), joined on the slices' own devices
    (bring them to one first)."""
    axes = [(d, a) for d, a in enumerate(spec) if a is not None and mesh.shape[a] > 1]
    if not axes:
        return parts[0]
    pieces = {
        tuple(mesh.index(r, a) for _, a in axes): parts[r]
        for r in mesh.group(0, [a for _, a in axes])
    }
    for k in reversed(range(len(axes))):
        merged: Dict[Tuple[int, ...], List[torch.Tensor]] = {}
        for key in sorted(pieces):
            merged.setdefault(key[:k], []).append(pieces[key])
        pieces = {key: torch.cat(v, dim=axes[k][0]) for key, v in merged.items()}
    return pieces[()]


def replica_of(spec: Sequence[Optional[str]], mesh: Mesh, rank: int) -> int:
    """The first rank that holds the same slice under ``spec`` as ``rank``
    (itself when no earlier rank does): the ranks that agree on every
    axis the spec splits over."""
    on = [a for a in spec if a is not None]
    c = mesh.coords(rank)
    return next(r for r in range(mesh.size) if all(mesh.index(r, a) == c[a] for a in on))


def stage_layers(num_layers: int, pp: int, stage: int) -> range:
    """The layers of pipeline stage ``stage`` of ``pp``: the ``stage``-th
    of ``pp`` equal contiguous runs of ``range(num_layers)``, as
    ``"layers": "pp"`` cuts a layer stack. A ``pp`` that does not divide
    ``num_layers`` raises, as the reference's placement does."""
    if num_layers % pp:
        raise ValueError(f"num_layers={num_layers} is not divisible by pp={pp}")
    per = num_layers // pp
    return range(stage * per, (stage + 1) * per)


def make_mesh(
    plan: MeshPlan, devices: Sequence[Union[str, torch.device]], group: Any = None
) -> Mesh:
    """A :class:`Mesh` for ``plan`` over ``devices``. With a gang's
    process ``group``, ``devices`` are this process's own and the global
    list is every process's in process order (a gang's members run with
    the same options, so each names its own the same way): they must
    number ``plan.size`` over the group's size. A gang's mesh with ``pp``
    above 1 raises: its stages would run a host each (ROADMAP.md queue 1
    item 15, pipeline stages across hosts); one process realises ``pp``."""
    devices = list(devices)
    if group is not None:
        if plan.pp > 1:
            raise NotImplementedError(
                f"mesh axis pp={plan.pp} across a gang's processes is not ported yet: one process realises "
                "it (ROADMAP.md queue 1 item 15, pipeline stages across hosts)"
            )
        import torch.distributed as dist

        n = dist.get_world_size(group)
        if plan.size != len(devices) * n:
            raise ValueError(
                f"mesh plan {plan} needs {plan.size} devices, have {len(devices)} local devices x {n} processes"
            )
        return Mesh(plan, devices * n, group=group)
    if plan.size != len(devices):
        raise ValueError(f"mesh plan {plan} needs {plan.size} devices, have {len(devices)}")
    return Mesh(plan, devices)


def serving_mesh(
    tp: int, devices: Optional[Sequence[Union[str, torch.device]]] = None, group: Any = None
) -> Mesh:
    """The engine's tp mesh. ``devices=None`` takes the first ``tp`` CUDA
    devices (in a gang, this process's share of them) and raises when
    there are fewer; an explicit list is taken as given (it may name one
    device more than once) and must have ``tp`` entries, or in a gang
    ``tp`` over the ``group``'s processes (:func:`make_mesh`)."""
    if tp < 1:
        raise ValueError("tensor_parallel_size must be >= 1")
    if devices is None:
        n = 1
        if group is not None:
            import torch.distributed as dist

            n = dist.get_world_size(group)
        if tp % n:
            raise ValueError(f"tensor_parallel_size {tp} does not divide over {n} processes")
        need = tp // n
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise ValueError(f"tensor_parallel_size {tp} needs {need} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(need)]
    return make_mesh(MeshPlan(tp=tp), list(devices), group=group)
