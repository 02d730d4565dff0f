"""Heterogeneous model-parallel worker fleets (paper §6).

* ``FleetSpec`` — the **single source of truth** for per-worker model-parallel
  degrees.  Everything derives from one spec: the controller's degree vector,
  the per-worker virtual token times, the placement DP's sort-and-zip
  mapping (§6.1: workers descend by MP degree, partitions descend by length)
  and the meshes the workers are built on.

* ``RolloutFleet`` — owns the live ``RolloutWorker`` set.  Construction carves
  one disjoint block of ``devices`` per worker (``launch.mesh.
  carve_worker_meshes``), and a worker of degree ``d`` > 1 holds 1/d of its
  attention, MLP and vocabulary weights and of its kv heads on each of its
  ``d`` devices (``distributed/sharding.py``).  ``devices`` defaults to the
  fleet's one ``device``, which covers no degree above 1: every worker then
  runs unsharded on it (workers on one card share one copy of the params)
  and the *declared* degrees drive the control plane only, as in the
  reference on a host that cannot hold the meshes.  ``reconfigure``
  executes the simulated-annealing allocator's split/merge moves between
  rollout steps — workers whose degree, mesh presence and device block
  survive are reused (their radix caches stay warm), changed slots are
  rebuilt on newly carved meshes (weights re-sharded from the fleet's
  un-sharded copy), and the resident sequences of retired workers are moved
  lane by lane onto the new fleet (``migrate_out`` gathers the shards to the
  full layout on the source's device 0, ``migrate_in`` cuts it for the
  destination's mesh, so moves cross MP degrees, card to card).  The fleet
  keeps its un-sharded copy of the params on ``device``, so a fleet serves
  only a configuration whose whole params fit one card; a single worker
  takes weights made already cut (``init_params(mesh=)``).  The fleet owns
  one ``engine.tracing.Tracer`` (``tracer``, off until switched on) and
  hands it to every worker it builds, rebuilt ones included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.engine.sampler import SamplerConfig
from repro_torch.device import resolve_device
from repro_torch.engine.tracing import Tracer
from repro_torch.engine.worker import RolloutWorker
from repro_torch.launch.mesh import carve_worker_meshes
from repro_torch.models import model as M


@dataclass(frozen=True)
class FleetSpec:
    """Per-worker MP degrees, descending — the §6.1 sort-and-zip order."""

    degrees: tuple[int, ...]

    def __post_init__(self):
        if not self.degrees:
            raise ValueError("FleetSpec needs at least one worker")
        if any(int(d) < 1 for d in self.degrees):
            raise ValueError(f"MP degrees must be >= 1, got {self.degrees}")
        if list(self.degrees) != sorted(self.degrees, reverse=True):
            raise ValueError(
                "degrees must be descending (sort-and-zip mapping relies on "
                f"worker order == degree order), got {self.degrees}",
            )

    @property
    def n_workers(self) -> int:
        return len(self.degrees)

    @property
    def budget(self) -> int:
        """Total accelerators consumed (the Algorithm 2 budget N)."""
        return int(sum(self.degrees))

    @classmethod
    def homogeneous(cls, n_workers: int, mp: int = 1) -> "FleetSpec":
        return cls(tuple([int(mp)] * n_workers))

    @classmethod
    def from_degrees(cls, degrees: Sequence[int]) -> "FleetSpec":
        return cls(tuple(sorted((int(d) for d in degrees), reverse=True)))

    @classmethod
    def from_allocation(cls, allocation) -> "FleetSpec":
        """Adopt an AllocationResult (Algorithm 2 output) as the fleet shape."""
        return cls.from_degrees(allocation.degrees)


class RolloutFleet:
    """The live heterogeneous worker set and its between-steps reconfiguration."""

    def __init__(
        self,
        cfg,
        params,
        spec: FleetSpec,
        *,
        capacity: int,
        max_slots: int,
        sampler: SamplerConfig = SamplerConfig(),
        seed: int = 0,
        device=None,
        devices=None,
        **worker_kwargs,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the un-sharded copy: unsharded workers share it, meshed ones cut it
        self.params = M.tree_to(params, self.device)
        self.devices = [self.device] if devices is None else list(devices)
        self.capacity = capacity
        self.max_slots = max_slots
        self.sampler = sampler
        self.seed = seed
        self.worker_kwargs = dict(worker_kwargs)
        self.spec = spec
        self.reconfigurations = 0
        self.tracer = Tracer()
        meshes = carve_worker_meshes(spec.degrees, self.devices)
        self.workers = [self._build_worker(i, degree, mesh)
                        for i, (degree, mesh) in enumerate(zip(spec.degrees, meshes))]

    def _build_worker(self, wid: int, degree: int, mesh) -> RolloutWorker:
        return RolloutWorker(
            self.cfg,
            self.params,
            capacity=self.capacity,
            max_slots=self.max_slots,
            worker_id=wid,
            sampler=self.sampler,
            seed=self.seed,
            mp=degree,
            device=self.device,
            mesh=mesh,
            tracer=self.tracer,
            **self.worker_kwargs,
        )

    def reconfigure(self, new_spec: FleetSpec) -> dict:
        """Realize ``new_spec`` on the live fleet (split / merge / redistribute).

        Worker slots whose degree, mesh presence and device block are
        unchanged keep their engine (KV pool, radix cache, retired lanes all
        stay warm).  Changed or new slots get a fresh worker on a newly carved
        mesh — the weight re-shard of a split/merge move.  Resident sequences
        of every retired engine are migrated onto the new fleet (same slot
        index when it exists, else the least-populated new worker), card to
        card.  Returns a
        report dict; the caller (runtime / controller) must re-sync
        ``controller.degrees`` from ``fleet.spec`` — ``FleetSpec`` stays the
        only authority.
        """
        old_spec, old_workers = self.spec, self.workers
        meshes = carve_worker_meshes(new_spec.degrees, self.devices)
        # a slot is reusable only if its degree, its mesh PRESENCE, and its
        # device block all survive: a fleet crossing in or out of the meshed
        # regime must re-place every worker, and an earlier split/merge
        # shifts every later carve offset, where a reused worker keeping its
        # old mesh would overlap a rebuilt neighbour's devices.
        old_off = [sum(old_spec.degrees[:i]) for i in range(old_spec.n_workers)]
        new_off = [sum(new_spec.degrees[:i]) for i in range(new_spec.n_workers)]
        reused = []
        workers = []
        for i, (degree, mesh) in enumerate(zip(new_spec.degrees, meshes)):
            same = i < len(old_workers) and old_spec.degrees[i] == degree
            if same and (mesh is None) != (old_workers[i].mesh is None):
                same = False
            elif same and mesh is not None:
                same = old_off[i] == new_off[i]
            if same:
                workers.append(old_workers[i])
                reused.append(i)
            else:
                workers.append(self._build_worker(i, degree, mesh))
        moves: dict[int, int] = {}  # seq_id -> destination worker index
        for i, old in enumerate(old_workers):
            if i in reused:
                continue
            for seq_id in list(old.store):
                pkg = old.migrate_out(seq_id)
                if i < len(workers):
                    dst = workers[i]
                else:  # fleet shrank past this slot: redistribute (elastic case)
                    dst = min(workers, key=lambda w: len(w.store))
                dst.migrate_in(pkg)
                moves[seq_id] = dst.worker_id
        self.spec = new_spec
        self.workers = workers
        self.reconfigurations += 1
        rebuilt = [i for i in range(new_spec.n_workers) if i not in reused]
        return {
            "from": list(old_spec.degrees),
            "to": list(new_spec.degrees),
            "reused": reused,
            "rebuilt": rebuilt,
            "migrated_residents": len(moves),
            "moves": moves,
        }
