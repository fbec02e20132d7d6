"""The ``(dp, sp)`` grid of genome cells of the mesh engine (the counterpart
of grom_tpu/parallel/mesh.py).

One launch of the mesh engine processes ``n_dp * n_sp`` consecutive genome
cells, numbered row-major over the grid. The cells map onto devices:

* within a process, onto a list of ``torch.device``s, one per cell. The
  list may repeat a device, so several cells of a launch can share one card
  (or the CPU, in the tests);
* across the processes of a ``torch.distributed`` group, process-major:
  process ``r`` of ``W`` owns launch cells ``[r * n / W, (r + 1) * n / W)``,
  which are whole ``dp`` rows when ``W`` divides ``n_dp`` (the layout of
  grom_tpu's ``jax.devices()`` reshaped row-major over the mesh).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def current_group():
    """The default ``torch.distributed`` group when one is initialized,
    else None (the exchange between cells is then local)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def visible_cuda_devices() -> List[torch.device]:
    """Every CUDA device this process sees. A program that runs several
    ranks on one host gives each its own cards (``CUDA_VISIBLE_DEVICES``,
    or ``make_mesh(devices=...)``)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An ``(n_dp, n_sp)`` grid of cells; ``devices`` holds one device per
    cell this process owns (``n_local`` of them), ``group`` the process
    group the cells span (None: this process owns every cell)."""

    def __init__(self, n_dp: int, n_sp: int, devices: Sequence, group=None):
        self.n_dp, self.n_sp = int(n_dp), int(n_sp)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        n = self.n_dp * self.n_sp
        if n < 1 or n % self.world:
            raise ValueError("a %dx%d grid does not split over %d processes"
                             % (self.n_dp, self.n_sp, self.world))
        self.n_local = n // self.world
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.n_local:
            raise ValueError("%d devices for the %d cells of this process"
                             % (len(self.devices), self.n_local))

    @property
    def shape(self):
        return self.n_dp, self.n_sp

    @property
    def n_cells(self) -> int:
        return self.n_dp * self.n_sp

    @property
    def first_cell(self) -> int:
        """Index, within a launch, of this process's first cell."""
        return self.rank * self.n_local


def make_mesh(n_dp: int, n_sp: int, devices: Optional[Sequence] = None,
              group="current") -> Mesh:
    """An ``(n_dp, n_sp)`` grid over ``devices`` (default: this process's
    visible CUDA devices), of which this process takes the first
    ``n_local``. ``group`` defaults to the initialized default process
    group, if any."""
    if group == "current":
        group = current_group()
    if devices is None:
        devices = visible_cuda_devices()
    world = dist.get_world_size(group) if group is not None else 1
    n_local = n_dp * n_sp // world
    if len(devices) < n_local:
        raise ValueError("not enough devices: %d for %d cells"
                         % (len(devices), n_local))
    return Mesh(n_dp, n_sp, list(devices)[:n_local], group)
