"""Worker meshes: the devices a rollout worker of MP degree ``d`` computes on
(counterpart of ``repro/launch/mesh.py``).

The JAX package gives each worker a ``("data", "model")`` sub-mesh and lets
GSPMD run collectives on it.  The port keeps one controlling process and
makes the collectives explicit: a ``WorkerMesh`` is the worker's devices in
shard order, and its ``reduce`` and ``gather`` are the two collectives the
tensor-parallel split needs.  A device may repeat (``[cpu] * 4`` in the
tests, ``[cuda:0] * 2`` on one card): each shard is then a separate set of
tensors on that device.  The devices may also be distinct cards
(``cuda:0 ... cuda:d-1``): the collectives are then peer copies between
cards, issued on the cards' current streams, which wait for each other's
work with events, so no collective waits on the host.  No process group
and no NCCL collective is used: the partials are summed by one process on
device 0, in shard order and in f32, so a degree's sums are the same
arithmetic, and its outputs bit-equal, whether its shards share one card or
lie on distinct ones.

``make_production_mesh`` is the counterpart of the reference's production
meshes (a 16x16 TPU pod, two of them): the layout of H100 hosts that the
dry run (``launch/dryrun.py``) reckons per card, described and never
allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class WorkerMesh:
    """One worker's devices, in shard order (shard ``r`` on ``devices[r]``)."""

    devices: tuple[torch.device, ...]

    @property
    def degree(self) -> int:
        return len(self.devices)

    def peer_access(self) -> dict[tuple[int, int], bool]:
        """For each ordered pair of distinct cards of the mesh, whether the
        first can read the second's memory directly (a peer copy over NVLink
        or PCIe; without it the copy is staged through the host).  Empty
        when the mesh holds fewer than two distinct cards."""
        cards = sorted({d.index for d in self.devices if d.type == "cuda"})
        return {(a, b): torch.cuda.can_device_access_peer(a, b)
                for a in cards for b in cards if a != b}

    def broadcast(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` on every shard's device (no copy where it already lies)."""
        return [x.to(dev) for dev in self.devices]

    def reduce(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The sum of the shards' partial outputs, added in shard order on
        device 0 (in f32 for narrower dtypes, then cast back once), copied back
        to every shard's device.  The same additions on the same device
        whatever the placement: on distinct cards only the copies change."""
        acc_dtype = torch.promote_types(parts[0].dtype, torch.float32)
        dev0 = self.devices[0]
        total = parts[0].to(dev0, acc_dtype)
        for p in parts[1:]:
            total = total + p.to(dev0, acc_dtype)
        return self.broadcast(total.to(parts[0].dtype))

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The shards' pieces concatenated along ``dim`` on device 0."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=dim)


# Cards a host: an HGX H100 board holds eight, joined all to all by NVLink.
# This is the production layout's premise, not a measurement of any host.
HOST_CARDS = 8


@dataclass(frozen=True)
class ProductionLayout:
    """The production layout: ``replicas`` hosts (the data axis), each one
    worker of MP degree ``HOST_CARDS`` over its host's cards (the model
    axis, the NVLink domain that one controlling process's ``WorkerMesh``
    spans).  ``mesh`` is one replica's worker mesh, over whatever device
    the caller named."""

    replicas: int
    mesh: WorkerMesh

    @property
    def degree(self) -> int:
        return self.mesh.degree

    @property
    def shape(self) -> tuple[int, ...]:
        """(data, model) on one host, (pod, data, model) on two: the
        reference's axes, each host's data axis 1."""
        return (1, self.degree) if self.replicas == 1 else (self.replicas, 1, self.degree)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.shape))

    @property
    def chips(self) -> int:
        return self.replicas * self.degree

    @staticmethod
    def batch(global_batch: int, replicas: int) -> int:
        """A replica's batch: ``global_batch`` split over ``replicas`` where
        it divides, else the whole batch on every replica (as the reference
        shards only a divisible batch: ``long_500k``'s batch of 1 stays
        whole)."""
        return global_batch // replicas if global_batch % replicas == 0 else global_batch


def make_production_mesh(*, multi_pod: bool = False, device="meta") -> ProductionLayout:
    """One host of ``HOST_CARDS`` cards (``1x8``, 8 chips), or with
    ``multi_pod`` two (``2x1x8``, 16 chips; the data axis of 2 splits the
    batch across the hosts' replicas).  The worker mesh lists ``device``
    ``HOST_CARDS`` times: ``meta`` by default, so that nothing is allocated
    and no card is needed."""
    return ProductionLayout(2 if multi_pod else 1,
                            WorkerMesh((torch.device(device),) * HOST_CARDS))


def carve_worker_meshes(degrees: Sequence[int], devices=None) -> list[WorkerMesh | None]:
    """One mesh per rollout worker, over disjoint contiguous blocks of ``devices``.

    Worker ``i`` of degree ``degrees[i]`` takes the next ``degrees[i]`` entries
    of the device list, so a fleet like {4, 2, 1, 1} occupies eight entries
    without overlap, and a degree-1 worker in a meshed fleet gets a one-device
    mesh on its reserved entry.  An all-mp1 fleet gets ``None`` for every
    worker (nothing to shard), and so does a fleet the list cannot cover
    (``sum(degrees) > len(devices)``): the declared degrees then drive the
    control plane only, as in the reference.  ``devices=None`` means every
    visible card, and raises where there is none: {2, 1, 1} over four cards
    puts worker 0's two shards on ``cuda:0`` and ``cuda:1`` and workers 1
    and 2 on ``cuda:2`` and ``cuda:3``.  A list that repeats a device
    (``["cuda:0"] * 4``) places every shard on it, with the same sums in the
    same order (``WorkerMesh.reduce``).
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    degrees = [int(d) for d in degrees]
    if sum(degrees) > len(devices) or all(d == 1 for d in degrees):
        return [None] * len(degrees)
    meshes: list[WorkerMesh | None] = []
    off = 0
    for d in degrees:
        meshes.append(WorkerMesh(tuple(devices[off:off + d])))
        off += d
    return meshes
