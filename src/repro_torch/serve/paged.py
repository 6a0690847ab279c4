"""Paged KV cache: fixed-size pages, slot -> page table, no reallocation.

Port of ``repro.serve.paged``. Sequence-indexed cache entries live in a page
pool ``(L, n_pages + 1, page_size, *tail)``; a slot owns pages through a
host-side page table ``(n_slots, blocks_per_slot)`` and pages are allocated
lazily as positions advance, so ``n_pages < n_slots * blocks_per_slot``
oversubscribes KV memory (the batcher preempts when the free list runs
dry). Page ``n_pages`` is a write sink: inactive slots and unallocated table
entries point at it, and decode never reads it unmasked (``kpos <= pos``
per row), so its contents are arithmetic-neutral. Entries that are not
sequence-indexed (a mamba layer's state, a sliding-window layer's ring)
stay dense per slot, ``(L, n_slots, ...)``: admission writes the slot's
whole row (a ring zero-padded by prefill when the prompt is shorter than
the window), and decode updates them in place, each row only its own; an
inactive row's entries are put back as they were before the step
(``held_rows``), so a free slot's state changes only at its admission.
A hybrid model (jamba) holds both kinds at once: its attention layers'
K/V in pages, its mamba layers' states per slot.

The dense decode view is one gather per entry (``assemble``); the decode
step's single written position per row goes back with one scatter
(``writeback``); admission writes a B=1 prefill cache into the slot's pages
with one scatter (``admit_scatter``). The pool is updated in place.

On a mesh (``shard``): the page table, the free list and every decision
are global and the same on every rank, and so is the pool's layout: each
rank holds the whole pool, every page and every slot's row, and reads and
writes only its part of it: the rows of its batch shard, and of the
sequence-indexed entries the blocks of its sequence range (a block is a
page, so a page a rank never touches stays zero there). The pool costs
every rank the bytes of the whole pool (qwen2-0.5b at 4 slots of 256,
pages of 16: 12,779,520 bytes with the sink page), in return for the
reference's page ids, allocation order and counters unchanged. A rank's
dense decode view is its rows over its sequence range; ``page_size`` must
divide that range, max_len / n_seq.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.config import ShapeConfig


def seq_entry_keys(model, shape: ShapeConfig) -> set[tuple[str, str]]:
    """(kind, name) pairs whose caches are sequence-indexed (pageable)."""
    shapes = model.cache_shapes(shape)
    return {(kind, name)
            for kind, entry in shapes.items()
            for name, (_, _, seq_shard) in entry.items() if seq_shard}


@dataclass
class PagedKV:
    """Page-pool layout + host-side page table for one decode shape.

    ``shape`` is the decode ShapeConfig: ``global_batch`` = n_slots,
    ``seq_len`` = max_len. The page table and free list live on the host
    (numpy) and are uploaded per step."""
    model: object
    shape: ShapeConfig
    page_size: int
    n_pages: int = 0          # 0 = fully provisioned (no oversubscription)
    seq_keys: set = field(init=False)
    blocks_per_slot: int = field(init=False)
    table: np.ndarray = field(init=False)
    free: list = field(init=False)
    owner: np.ndarray = field(init=False)   # page -> slot (-1 free)

    def __post_init__(self):
        n_slots, max_len = self.shape.global_batch, self.shape.seq_len
        assert max_len % self.page_size == 0, (max_len, self.page_size)
        self.blocks_per_slot = max_len // self.page_size
        if not self.n_pages:
            self.n_pages = n_slots * self.blocks_per_slot
        self.seq_keys = seq_entry_keys(self.model, self.shape)
        self.table = np.full((n_slots, self.blocks_per_slot), -1, np.int32)
        self.free = list(range(self.n_pages))
        self.owner = np.full((self.n_pages,), -1, np.int32)
        self.shard(0, n_slots, 0, 1)

    def shard(self, row0: int, n_rows: int, seq_index: int, n_seq: int):
        """This rank's part of the pool: slots [row0, row0 + n_rows) and,
        of the sequence-indexed entries, the ``seq_index``-th of ``n_seq``
        equal block ranges."""
        if self.blocks_per_slot % n_seq:
            raise ValueError(f"page size {self.page_size} does not divide "
                             f"the sequence range {self.shape.seq_len} / "
                             f"{n_seq}")
        nb = self.blocks_per_slot // n_seq
        self.rows = slice(row0, row0 + n_rows)
        self.blocks = slice(seq_index * nb, (seq_index + 1) * nb)
        self.seq_off = seq_index * nb * self.page_size
        self.seq_len_loc = nb * self.page_size

    # -- host-side page accounting ------------------------------------------

    def pages_needed(self, length: int) -> int:
        return -(-length // self.page_size)

    def free_pages(self) -> int:
        return len(self.free)

    def alloc(self, slot: int, block: int) -> bool:
        """Allocate page for ``table[slot, block]``; False if none free."""
        if self.table[slot, block] >= 0:
            return True
        if not self.free:
            return False
        page = self.free.pop(0)
        self.table[slot, block] = page
        self.owner[page] = slot
        return True

    def alloc_prefix(self, slot: int, length: int) -> bool:
        """Allocate the first ``pages_needed(length)`` pages of a slot."""
        need = self.pages_needed(length)
        if len([b for b in range(need) if self.table[slot, b] < 0]) \
                > len(self.free):
            return False
        return all(self.alloc(slot, b) for b in range(need))

    def release(self, slot: int):
        """Return a finished/preempted slot's pages to the free list."""
        for b in range(self.blocks_per_slot):
            page = self.table[slot, b]
            if page >= 0:
                self.owner[page] = -1
                self.free.append(int(page))
                self.table[slot, b] = -1

    def device_table(self, device) -> torch.Tensor:
        """Page table with unallocated entries redirected to the sink."""
        return torch.as_tensor(np.where(self.table < 0, self.n_pages,
                                        self.table).astype(np.int64),
                               device=device)

    # -- device-side layout --------------------------------------------------

    def init_pool(self, cache_shapes, device):
        """Zero pool state for the global dense cache shapes ``{kind: {name:
        (shape, dtype, seq_indexed)}}``, plus the shared ``pos``."""
        pool = {}
        for kind, entry in cache_shapes.items():
            pool[kind] = {}
            for name, (shape, dtype, _) in entry.items():
                if (kind, name) in self.seq_keys:
                    shape = (shape[0], self.n_pages + 1, self.page_size) \
                        + tuple(shape[3:])
                pool[kind][name] = torch.zeros(shape, dtype=dtype,
                                               device=device)
        pool["pos"] = torch.zeros((), dtype=torch.int32, device=device)
        return pool

    def assemble(self, pool, table):
        """Pool state -> this rank's dense decode view: one gather per
        pageable entry. ``table`` is the global device table; row r of the
        view is this rank's blocks of slot ``rows.start + r`` in order.
        The other entries are views of this rank's rows (decode updates
        them in place)."""
        table = table[self.rows, self.blocks]
        out = {}
        for kind, entry in pool.items():
            if kind == "pos":
                out[kind] = entry
                continue
            out[kind] = {}
            for name, v in entry.items():
                if (kind, name) in self.seq_keys:
                    d = v[:, table]          # (L, B, blocks, page, *tail)
                    out[kind][name] = d.reshape(
                        d.shape[:2] + (d.shape[2] * d.shape[3],) + d.shape[4:])
                else:
                    out[kind][name] = v[:, self.rows]
        return out

    def held_rows(self, dense) -> dict:
        """Copies of the per-slot entries of ``assemble``'s view, taken
        before a decode step updates them in place (``writeback`` restores
        the inactive rows from them)."""
        return {(kind, name): d.clone()
                for kind, entry in dense.items() if kind != "pos"
                for name, d in entry.items() if (kind, name) not in self.seq_keys}

    def writeback(self, pool, dense_new, table, row_pos, active, held):
        """Scatter the decode step's written position back into the pool.

        ``row_pos`` and ``active`` are this rank's rows. Each active row
        wrote exactly one new position (``row_pos``), at page-local address
        ``(table[r, pos // page], pos % page)``; inactive rows, and rows
        whose position lies outside this rank's sequence range, go to the
        sink page. The other entries were updated in place in the view:
        an active row keeps its update, an inactive one gets its entry of
        ``held`` (``held_rows`` before the step) back."""
        b = row_pos.shape[0]
        rows = torch.arange(b, device=row_pos.device)
        grows = rows + self.rows.start if self.rows.start else rows
        block = row_pos // self.page_size
        if self.seq_len_loc == self.shape.seq_len:
            # the whole sequence: every position is this rank's
            mine, local = active, row_pos
        else:
            mine = active & (block >= self.blocks.start) \
                & (block < self.blocks.stop)
            block = block.clamp(max=self.blocks_per_slot - 1)
            local = (row_pos - self.seq_off).clamp(0, self.seq_len_loc - 1)
        page_i = torch.where(mine, table[grows, block], self.n_pages)
        off = row_pos % self.page_size
        for kind, entry in dense_new.items():
            if kind == "pos":
                pool[kind] = entry
                continue
            for name, d in entry.items():
                if (kind, name) in self.seq_keys:
                    pool[kind][name][:, page_i, off] = d[:, rows, local]
                else:
                    keep = active.view((1, b) + (1,) * (d.ndim - 2))
                    pool[kind][name][:, self.rows] = torch.where(
                        keep, d, held[kind, name])
        return pool

    def admit_scatter(self, pool, c1, slot: int, slot_pages: torch.Tensor):
        """B=1 prefill cache, whole over the prompt -> the slot's pages of
        this rank's sequence range (pageable entries, cut into whole
        zero-padded pages) and its row (per-slot entries)."""
        n_pp = slot_pages.shape[0]
        mine = slice(self.blocks.start, min(self.blocks.stop, n_pp))
        for kind, entry in pool.items():
            if kind == "pos":
                pool[kind] = torch.maximum(entry, c1["pos"])
                continue
            for name, dst in entry.items():
                src = c1[kind][name].to(dst.dtype)
                if (kind, name) in self.seq_keys:
                    if mine.start >= mine.stop:
                        continue
                    row = src[:, 0]                       # (L, P, *tail)
                    pad = n_pp * self.page_size - row.shape[1]
                    if pad:
                        row = torch.cat([row, row.new_zeros(
                            (row.shape[0], pad) + row.shape[2:])], dim=1)
                    row = row.reshape((row.shape[0], n_pp, self.page_size)
                                      + row.shape[2:])
                    dst[:, slot_pages[mine]] = row[:, mine]
                else:
                    dst[:, slot] = src[:, 0]
        return pool
