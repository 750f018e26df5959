"""Device mesh and the context-parallel KV cache layout.

Port of ``lmdeploy_tpu/parallel/mesh.py`` for context parallelism (CP).  The design is
single-controller, as the reference's is: one engine process drives every rank.  A
``Mesh`` names a torch device per rank over the axes ``('dp', 'ep', 'cp', 'tp')``;
where the reference's ``shard_map`` runs each rank on its own chip, the port runs
each rank's kernel on that rank's device and gathers the results in rank order on
the mesh's first device.  One card may hold several ranks (an explicit device list
may repeat it), as the reference's tests put its ranks on virtual CPU devices.

Under CP the cache's slot axis is striped over the ranks (``cache_sharding``): rank r
holds the slots ``[r*BS/cp, (r+1)*BS/cp)`` of every page, so a long row's K/V, and its
decode reads, spread evenly over the ranks.  ``StripedKV`` is that cache: one
``[L, NB, 2, BS/cp, Hkv*D]`` stripe per rank on the rank's device.  Weights are
replicated (the model runs on the mesh's first device); tensor, data and expert
parallelism are not ported yet (``config.check_ported`` raises on them).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

AXES = ('dp', 'ep', 'cp', 'tp')


def _indexed(device) -> torch.device:
    """``device`` with its index ('cuda' -> the current card's 'cuda:i'), so that it
    compares equal to the device of a tensor placed there."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


class Mesh:
    """Ranks over the axes ``AXES`` (tp innermost), a torch device each, in row-major
    order of the axes."""

    axis_names = AXES

    def __init__(self, devices: Sequence[torch.device], shape: Dict[str, int]):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        n = 1
        for a in AXES:
            n *= self.shape[a]
        if len(devices) != n:
            raise ValueError(f'a mesh of shape {self.shape} needs {n} devices, got '
                             f'{len(devices)}')
        self.devices: Tuple[torch.device, ...] = tuple(_indexed(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, every other axis at its first index."""
        stride = 1
        for a in AXES[AXES.index(axis) + 1:]:
            stride *= self.shape[a]
        return tuple(self.devices[i * stride] for i in range(self.shape[axis]))

    @property
    def cp_devices(self) -> Tuple[torch.device, ...]:
        return self.axis_devices('cp')

    def __repr__(self):
        return f'Mesh({self.shape}, devices={[str(d) for d in self.devices]})'


def build_mesh(dp: int = 1, tp: int = 1, ep: int = 1, cp: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``dp*ep*cp*tp`` ranks.  ``devices=None`` takes ``cuda:0 .. cuda:n-1``
    and raises when fewer cards are visible: it never repeats a card and never falls
    back to the CPU.  An explicit list (its first n entries are used) may repeat a
    device: ``['cuda:0', 'cuda:0']`` puts two ranks on one card, ``['cpu'] * n`` runs
    the ranks on the CPU."""
    n = dp * tp * ep * cp
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f'a mesh of {n} ranks needs {n} CUDA devices, {have} '
                               f'visible; pass devices= to place several ranks on one')
        devices = [f'cuda:{i}' for i in range(n)]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f'a mesh of {n} ranks needs {n} devices, got {len(devices)}')
    return Mesh(devices[:n], {'dp': dp, 'ep': ep, 'cp': cp, 'tp': tp})


class CacheSpec(NamedTuple):
    """Where the cache's axes go: the slot axis over ``slot`` ('cp' or None), the
    head-major row width over ``head`` ('tp' or None), ``cp`` ranks on the slot axis
    (the reference's ``PartitionSpec(None, None, None, slot, head)``)."""

    slot: Optional[str]
    head: Optional[str]
    cp: int

    def stripe(self, rank: int, block_size: int) -> slice:
        """The slots of every page that rank ``rank`` holds."""
        if self.slot is None:
            return slice(0, block_size)
        bsl = block_size // self.cp
        return slice(rank * bsl, (rank + 1) * bsl)


def cache_sharding(num_kv_heads: int = 0, cp: int = 1) -> CacheSpec:
    """The cache's sharding: each page's token slots striped over 'cp' when cp > 1;
    the head-major row width over 'tp', unless the cache has one kv head (MQA, the
    MLA latent), which stays replicated."""
    return CacheSpec('cp' if cp > 1 else None, None if num_kv_heads == 1 else 'tp', cp)


class StripedKV:
    """A plain paged cache striped over the 'cp' ranks: ``stripes[r]``
    ``[L, NB, 2, BS/cp, Hkv*D]`` on ``devices[r]`` holds rank r's slots of every page.
    ``.shape`` is the LOGICAL unsharded ``[L, NB, 2, BS, Hkv*D]`` (the model reads the
    block size from ``shape[3]``); ``.dtype`` / ``.device`` are the first stripe's."""

    def __init__(self, stripes: Sequence[torch.Tensor]):
        self.stripes = tuple(stripes)
        first = self.stripes[0]
        for s in self.stripes:
            if s.shape != first.shape or s.dtype != first.dtype:
                raise ValueError('the stripes of a cache share one shape and dtype')

    @property
    def cp(self) -> int:
        return len(self.stripes)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.stripes)

    @property
    def shape(self):
        L, NB, two, bsl, hd = self.stripes[0].shape
        return torch.Size((L, NB, two, bsl * self.cp, hd))

    @property
    def dtype(self):
        return self.stripes[0].dtype

    @property
    def device(self):
        return self.stripes[0].device

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.stripes)

    def clone(self) -> 'StripedKV':
        return StripedKV([s.clone() for s in self.stripes])

    def to_reference_layout(self) -> torch.Tensor:
        """The unsharded ``[L, NB, 2, BS, Hkv*D]`` cache on the first device: the
        stripes concatenated on the slot axis, bit for bit."""
        return torch.cat([s.to(self.device) for s in self.stripes], dim=3)

    @classmethod
    def from_reference_layout(cls, cache: torch.Tensor,
                              devices: Sequence[torch.device]) -> 'StripedKV':
        """Split an unsharded cache on its slot axis into ``len(devices)`` stripes, one
        on each device, bit for bit."""
        cp = len(devices)
        if cache.shape[3] % cp:
            raise ValueError(f'{cp} ranks do not divide the block size {cache.shape[3]}')
        return cls([c.to(d).contiguous() for c, d in zip(cache.chunk(cp, dim=3), devices)])
