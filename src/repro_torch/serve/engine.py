"""Single-card serving engine: continuous batching over a SPARTA-paged pool,
the port of ``src/repro/serve/engine.py``.

The device pool is one float32 tensor ``[L, P*S, page, Hkv, hd]`` whose slot
space is partition-major (slot = partition * S + local): the paper's
distributed memory collapsed onto one card.  Prefill goes through
:func:`~repro_torch.models.transformer.prefill_with_kv` (flash attention,
kernel K5) and is scattered into the pool through the block tables; each
decode step goes through :func:`~repro_torch.models.transformer.decode_step`
(paged attention, kernel K6, plus the hot tail).

Unlike the JAX engine, which rebuilds its pools functionally, this engine
updates the pools in place: prefill scatters, copy-on-write copies and the
decode step's new-token writes all index into the same two tensors.

It serves the decoder-only families through
:mod:`~repro_torch.models.transformer` alone: dense, moe, and vlm's
backbone on text prompts (image prefixes go through ``vlm.forward``).

Features: demand allocation (pages appear as sequences grow), prefix sharing
via ``fork`` + copy-on-write on the shared tail page, continuous batching
(requests join and leave the batch between steps).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paged_kv import PagedKVConfig, SpartaKVManager
from repro_torch.kernels.common import as_device, resolve_mode
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    seq_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class SpartaEngine:
    """``kernel_mode="auto"`` takes the kernels K5 and K6 on the card and
    the plain versions on the CPU; ``params`` must lie on ``device``."""

    def __init__(self, cfg: ModelConfig, params, *, num_partitions: int = 4,
                 slots_per_partition: int = 64, max_batch: int = 4,
                 kernel_mode: str = "auto", device="cuda"):
        self.device = as_device(device)
        resolve_mode(kernel_mode, self.device)       # validate early
        self.cfg = cfg
        self.params = params
        self.kernel_mode = kernel_mode
        self.max_batch = max_batch
        self.kv = SpartaKVManager(PagedKVConfig(
            num_partitions=num_partitions,
            slots_per_partition=slots_per_partition,
            page_size=cfg.kv_page_size,
        ))
        total = num_partitions * slots_per_partition
        shape = (cfg.num_layers, total, cfg.kv_page_size, cfg.num_kv_heads, cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.waiting: List[Request] = []
        self.active: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0

    # -- request API ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def fork_request(self, rid: int, max_new_tokens: int = 16) -> int:
        """Prefix sharing: continue a finished/active request as a new branch
        (beam-search-style) — pages are shared, the tail page copies on
        write."""
        src = self.finished.get(rid) or next(r for r in self.active if r.rid == rid)
        child_sid = self.kv.fork(src.seq_id)
        rid2 = self._next_rid
        self._next_rid += 1
        req = Request(rid2, src.prompt + src.generated, max_new_tokens, seq_id=child_sid)
        self.active.append(req)
        return rid2

    # -- internals ------------------------------------------------------------

    def _global_slot(self, partition: int, local: int) -> int:
        return partition * self.kv.cfg.slots_per_partition + local

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _prefill(self, req: Request) -> None:
        req.seq_id = self.kv.new_sequence()
        events = self.kv.append_tokens(req.seq_id, len(req.prompt))
        tokens = self._tensor(np.array(req.prompt, np.int32))[None]
        logits, kpages, vpages = tfm.prefill_with_kv(
            self.params, tokens, self.cfg, kernel_mode=self.kernel_mode)
        # Scatter the page-layout KV into the pool through the block table.
        for ev in events:
            g = self._global_slot(ev["partition"], ev["slot"])
            self.k_pool[:, g] = kpages[:, 0, ev["lp"]]
            self.v_pool[:, g] = vpages[:, 0, ev["lp"]]
        req.generated.append(int(torch.argmax(logits[0, -1])))

    def _apply_events(self, events: List[dict]) -> None:
        """Apply CoW copies (old slot -> new slot, same partition)."""
        for ev in events:
            if ev["kind"] == "cow":
                g_new = self._global_slot(ev["partition"], ev["slot"])
                g_old = self._global_slot(ev["partition"], ev["old_slot"])
                self.k_pool[:, g_new] = self.k_pool[:, g_old]
                self.v_pool[:, g_new] = self.v_pool[:, g_old]

    def step(self) -> int:
        """One engine tick: admit, decode one token for every active request,
        retire finished ones.  Returns the number of active requests."""
        while self.waiting and len(self.active) < self.max_batch:
            req = self.waiting.pop(0)
            self._prefill(req)
            self.active.append(req)
        if not self.active:
            return 0

        # Grow each sequence by one token (allocates pages on demand + CoW).
        for req in self.active:
            self._apply_events(self.kv.append_tokens(req.seq_id, 1))

        seqs = [r.seq_id for r in self.active]
        max_pages = max(len(self.kv.seq_pages(s)) for s in seqs)
        table = self.kv.global_block_table(seqs, max_pages)
        ctx = self.kv.context_lengths(seqs)
        last = np.array([(r.prompt + r.generated)[-1] for r in self.active], np.int32)

        logits, self.k_pool, self.v_pool = tfm.decode_step(
            self.params, self._tensor(last), self.cfg, self.k_pool, self.v_pool,
            self._tensor(table), self._tensor(ctx), kernel_mode=self.kernel_mode)
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i, req in enumerate(self.active):
            req.generated.append(int(nxt[i]))
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
        for req in [r for r in self.active if r.done]:
            self.active.remove(req)
            self.finished[req.rid] = req
        return len(self.active)

    def run_to_completion(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.step() and not self.waiting:
                return
