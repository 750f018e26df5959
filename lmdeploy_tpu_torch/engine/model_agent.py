"""ModelAgent: owns parameters, KV cache and decode state; runs forward + sampling.

Port of the main-path subset of ``lmdeploy_tpu/engine/model_agent.py``: ``_run`` with
``prefill`` / ``decode``, batch-slot management, the device-resident decode state
(``insert_decode_rows``, ``update_tables``, ``ensure_table_width``), ``decode_run``
with its greedy fast variant and its sampled variant, and ``warmup``.  A decode run is
k steps with the sampled token fed back on the device; the host fetches the ``[k, B]``
tokens once.  The reference's batch / chunk / table buckets are kept, so both engines
see the same padded shapes.

Where the reference jits each decode run per ``(k, B, simple, top_lp, kmax,
full_vocab)``, the port captures it as a CUDA graph per key (``graph_runner.py``) and
replays it; prefill steps run eagerly.  ``eager_mode`` (the reference's "disable
bucketing/jit warmup (debug)") runs every decode run eagerly, as the CPU does.  The
agent queues all of its device work, eager and replayed, on one stream of its own;
host arrays reach the card through pinned memory and results come back the same way,
so dispatching a step never waits for the card.  There is no donation: every cache and
state update is in place.  A hybrid linear-attention model's steps also pass each row's
batch slot and whether its chunk starts the sequence (``AttnMeta.slot_rows`` /
``reset_rows``), and its state snapshots and restores for prefix caching
(``snapshot_slot_state``, ``_apply_ssm_restores``) run on the agent's stream.  With
S-LoRA slot stacks attached (``enable_slora``) every step passes each row's adapter slot:
a prefill or host step from its sequence, a decode run from the state's ``adapter_id``
leaf, which the captured runs read.
"""
from __future__ import annotations

import contextlib
import heapq
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import EngineConfigBundle, bucketize, cp_unported, make_buckets
from ..models import build_model
from ..models.llama import AttnMeta
from ..nn.layers import make_rope_table
from ..ops.sampling import (GOLDEN, TOPK_CANDIDATES, SamplingInputs, sample_logits,
                            update_token_counts)
from ..ops.attention import KV_SIM_MODES
from ..ops.kv_quant import QuantKVTurbo, turbo_tables
from ..ops.moe import QUANT_RAGGED_MIN_TOKENS, RAGGED_MIN_TOKENS
from .cache_engine import CacheEngine
from .decode_state import DecodeState, host_rows_from_seqs, make_initial_state, to_device
from .graph_runner import DecodeGraphs, DecodeRun, RunKey

logger = logging.getLogger('lmdeploy_tpu_torch')


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that raises (pass ``'cpu'`` explicitly)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device available; pass device="cpu" to run '
                               'on the CPU')
        device = 'cuda'
    return torch.device(device)


def kv_sim_mode() -> Optional[str]:
    """LMDEPLOY_TPU_KV_SIM ('turbo', 'turbo_k', 'turbo_v'; unset or empty: off), read
    when an agent is built: its captured decode graphs could not see a later change."""
    mode = os.environ.get('LMDEPLOY_TPU_KV_SIM') or None
    if mode is not None and mode not in KV_SIM_MODES:
        raise ValueError(f'LMDEPLOY_TPU_KV_SIM={mode!r}: expected one of '
                         f'{sorted(KV_SIM_MODES)}')
    return mode


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host, queued on the current stream (into pinned memory)
    when ``t`` is on a card."""
    if not t.is_cuda:
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class StepOutput:
    """Host view of one step's results.  The outputs are copied into host buffers of
    this step's own as soon as the step is queued (a later step may overwrite the
    device buffers); the first access waits for that copy, and for nothing else."""

    def __init__(self, tokens, logprobs, top=None):
        self._copies = [_host_copy(t) for t in (tokens, logprobs, *(top or ()))]
        self._has_top = top is not None
        self._event = None
        if tokens.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        self._host = None

    def _fetch(self):
        if self._host is None:
            if self._event is not None:
                self._event.synchronize()
            arrays = [t.numpy() for t in self._copies]
            self._host = (arrays[0], arrays[1], tuple(arrays[2:]) if self._has_top else None)
        return self._host

    def tokens_np(self) -> np.ndarray:
        return self._fetch()[0]

    def logprobs_np(self) -> np.ndarray:
        return self._fetch()[1]

    def top_np(self):
        return self._fetch()[2]


def eager_reason(cp_devices, ragged_min_rows: Optional[int], B: int,
                 stacks: str = 'model') -> Optional[str]:
    """Why a decode run over a B-row bucket may not be captured (None: it may): a mesh
    whose cp ranks span several devices (one capture holds one card's launches), or an
    MoE model whose bucket reaches the grouped-GEMM route ``ops/moe.py _moe_ragged``,
    which reads the experts' group sizes on the host (``ragged_min_rows``: its
    threshold for the ``stacks`` named, None for a model without experts)."""
    if len(set(cp_devices)) > 1:
        return f'the cp ranks span {len(set(cp_devices))} devices'
    if ragged_min_rows is not None and B >= ragged_min_rows:
        return (f'a decode bucket of {B} rows takes the {stacks}\'s grouped expert GEMM '
                f'(from {ragged_min_rows} rows), which reads group sizes on the host')
    return None


def ragged_min_rows(params) -> Optional[int]:
    """The rows from which ``moe_ffn`` takes ``_moe_ragged`` on this tree's expert
    stacks (dense stacks, and W4A16 stacks that are widened at each step, from 128;
    MXFP4 and blocked-fp8 stacks from 768); None without experts.  A tree's layer groups
    are ``layers`` / ``moe_layers``, an MTP head's one layer ``layer``, a hybrid
    linear-attention model's ``blocks``."""
    for group in ('layers', 'moe_layers', 'layer', 'blocks'):
        leaf = params.get(group, {}).get('we_gate')
        if leaf is not None:
            quant = isinstance(leaf, dict) and ('nib' in leaf or 'w8' in leaf)
            return QUANT_RAGGED_MIN_TOKENS if quant else RAGGED_MIN_TOKENS
    return None


class ModelAgent:

    def __init__(self, configs: EngineConfigBundle, model_path: Optional[str] = None,
                 device=None, init_seed: int = 42, mesh=None, adapters=None):
        """``mesh`` (``parallel.mesh.Mesh``): the model runs on its first device and
        the KV cache is striped over its 'cp' ranks; ``device``, if given too, must be
        that first device.  ``adapters`` (name -> PEFT directory or parsed pair) serve
        S-LoRA (``enable_slora``)."""
        cfg = configs.model
        self.model = build_model(cfg)    # sets a hybrid model's num_cache_layers
        self.model.kv_sim = kv_sim_mode()
        if adapters:
            self._check_slora()
        if mesh is not None:
            self.device = mesh.devices[0]
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f'device {device} is not the first device of {mesh}')
            other = {a: n for a, n in mesh.shape.items() if a != 'cp' and n > 1}
            unported = [f'{a}={n}' for a, n in other.items()]
            unported += cp_unported(mesh.shape['cp'], configs.cache.quant_policy,
                                    configs.cache.block_size, configs.model)
            if unported:
                raise NotImplementedError(f'not ported yet: {", ".join(unported)}')
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.configs = configs
        self.model_config = cfg
        self.cache_config = configs.cache
        self.sched_config = configs.scheduler
        self.max_batch = configs.scheduler.max_batch_size
        self.max_model_len = configs.scheduler.max_session_len
        bs = configs.cache.block_size
        self.max_blocks_per_seq = (self.max_model_len + bs - 1) // bs

        if configs.misc.empty_init or model_path is None:
            params = self.model.init_params(init_seed, device=self.device)
        else:
            from ..weight_loader import load_params
            params = load_params(self.model, model_path, self.device)
        # S-LoRA adds to each projection's output: its leaves stay unfused
        self.params = self.prepare_params(self.model, params, fuse=not adapters)
        if adapters:
            self.enable_slora(adapters)

        cos, sin = make_rope_table(cfg.rope_dim, self.max_model_len, cfg.rope_theta,
                                   cfg.rope_scaling, device=self.device)
        self.rope_cos, self.rope_sin = cos, sin

        # after the weights (and S-LoRA stacks) are resident, so the free-memory
        # budget sees them (and a
        # hybrid model's per-slot state, allocated first: max_batch + 1 slots, the
        # last the garbage row of padding rows)
        self.has_linear_state = getattr(self.model, 'has_linear_state', False)
        self.cache_engine = CacheEngine(
            cfg, configs.cache, self.device, mesh=mesh,
            state_shapes=(self.model.state_shapes(self.max_batch + 1)
                          if self.has_linear_state else None))
        self.num_blocks = self.cache_engine.num_blocks
        if isinstance(self.cache_engine.pages, QuantKVTurbo):
            turbo_tables(cfg.cache_head_dim, self.rope_cos.device)
        if mesh is not None and mesh.shape['cp'] > 1:
            self.model.cp_mesh = mesh

        # one extra garbage row for padding slots
        counts_shape = (self.max_batch + 1, cfg.vocab_size)
        self.token_counts = torch.zeros(counts_shape, dtype=torch.int32,
                                        device=self.device)
        self.prompt_mask = torch.zeros(counts_shape, dtype=torch.bool, device=self.device)
        self._free_slots = list(range(self.max_batch))    # lowest-first (min holes)
        self._pending_deactivate = set()                  # slots freed while a step ran

        misc = configs.misc
        self.batch_buckets = misc.decode_buckets or make_buckets(self.max_batch)
        self.chunk_buckets = misc.prefill_buckets or make_buckets(
            configs.cache.max_prefill_token_num, minimum=16)
        self.table_buckets = make_buckets(self.max_blocks_per_seq)

        # block tables are tiny: keep them at full width from the start
        self.state_table_width = self.max_blocks_per_seq
        self.decode_state = make_initial_state(self.max_batch, self.state_table_width,
                                               self.token_counts, self.prompt_mask)
        # host sync once per this many decode steps
        self.decode_run_steps = 16

        # every device step of the agent, eager or replayed, goes on this one stream
        cuda = self.device.type == 'cuda'
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.eager_mode = misc.eager_mode
        # the speculative decoding extension (engine/spec_agent.py), when one is attached
        self.spec = None
        cp_devices = mesh.cp_devices if mesh is not None else ()
        ragged = ragged_min_rows(self.params)
        self.graphs = DecodeGraphs(
            self._decode_body, self.token_counts.device,
            capture=cuda and not self.eager_mode,
            eager_reason=lambda key: self._eager_reason(key, cp_devices, ragged))

    def prepare_params(self, model, params, fuse: bool = True):
        """A loaded tree in the form the agent serves it: one wide qkv GEMM and one
        gate/up GEMM per layer, unless LMDEPLOY_TPU_FUSE_PROJ=0 or not ``fuse``
        (S-LoRA); W4A16 linears then take
        a schedule's prepared form unless LMDEPLOY_TPU_W4_STACKED=0 (they stay
        unprepared: raw scales and zeros): the group-dot 'gd' by default, 'fast' with
        LMDEPLOY_TPU_W4_FAST=1, or the one LMDEPLOY_TPU_W4_SCHED names (reference
        model_agent.py:129-149).  Neither on a mesh, as in the reference.  A speculative
        draft model's tree takes the same form."""
        if (fuse and self.mesh is None
                and os.environ.get('LMDEPLOY_TPU_FUSE_PROJ', '1') != '0'):
            params = model.fuse_projections(params)
        if self.mesh is None and os.environ.get('LMDEPLOY_TPU_W4_STACKED', '1') != '0':
            fast = os.environ.get('LMDEPLOY_TPU_W4_FAST', '0') == '1'
            sched = os.environ.get('LMDEPLOY_TPU_W4_SCHED', 'gd' if not fast else '') or None
            params = model.prep_quant_leaves(params, fast=fast, mode=sched)
        return model.layout_quant_leaves(params)

    def _check_slora(self):
        """S-LoRA runs where the reference's does, in ``LlamaModel.forward`` with its
        silu gated MLP: a family with its own forward, or with its own MLP over
        ``w_gate`` leaves (Gemma's gelu), raises NotImplementedError naming it."""
        from ..models.llama import LlamaModel
        model = type(self.model)
        own_mlp = (model._mlp is not LlamaModel._mlp
                   and 'w_gate' in self.model.param_shapes()['layers'])
        if model.forward is not LlamaModel.forward or own_mlp:
            where = 'LlamaModel.forward' if not own_mlp else "LlamaModel's silu MLP"
            raise NotImplementedError(
                f'S-LoRA over {model.__name__} ({self.model.config.hf_arch}): the '
                f'reference applies adapters only in {where}')

    def enable_slora(self, adapters):
        """Load adapters into S-LoRA slot stacks (reference :544-567): ``adapters``
        maps each name to a PEFT directory or its parsed ``(weights, scaling)``
        (``lora.py``).  The stacks ride as ``params['lora']``, and each row's
        ``adapter_ids`` entry (0: none) picks its pair in the forward; the names'
        slots are ``lora_slot_map``.  ``__init__`` calls it on the unfused tree (the
        reference unfuses here), before the KV cache takes its share of the free
        memory and before any decode run is captured."""
        from ..lora import build_slora_stacks
        stacks, slot_map = build_slora_stacks(self.model, adapters, device=self.device)
        self.params = dict(self.params, lora=stacks)
        self.lora_slot_map = slot_map

    def _adapter_kw(self, ids) -> dict:
        """The forward's ``adapter_ids`` (``ids()``) when S-LoRA stacks are attached;
        nothing otherwise (a model with its own forward takes no such argument)."""
        return {'adapter_ids': ids()} if 'lora' in self.params else {}

    def _eager_reason(self, key, cp_devices, ragged) -> Optional[str]:
        """``eager_reason`` of a run key: a speculative step's verify rows against the
        target's stacks, then its draft rows (B) against the proposer's."""
        why = eager_reason(cp_devices, ragged, self._graph_rows(key))
        if why is None and key[0] == 'spec':
            why = eager_reason((), self.spec.draft_ragged, key[2], 'speculative proposer')
        return why

    def _graph_rows(self, key) -> int:
        """The batch rows a run's forward passes take: B for a decode run, B * (K+1)
        for a speculative step's verify."""
        if key[0] == 'spec':
            return key[2] * (self.spec.k + 1)
        return key[1]

    def _on_stream(self):
        """The agent's stream as the current one (a no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    @property
    def kv_cache(self):
        """The paged cache (``engine/cache_engine.py``): a tensor with quant_policy 0
        (model dtype) or 16 (fp8-e4m3), a ``QuantKV`` with 4, a ``QuantKV4`` with 8, a
        ``QuantKVTurbo`` with 42; a ``StripedKV`` under context parallelism; for a
        hybrid model the dict of those pages and its per-slot state."""
        return self.cache_engine.kv_cache

    # -- slot management --------------------------------------------------------------
    def assign_slot(self, seq) -> int:
        if seq.batch_slot < 0:
            seq.batch_slot = heapq.heappop(self._free_slots)
            # a reused slot is fully re-inserted; drop a stale pending deactivation
            self._pending_deactivate.discard(seq.batch_slot)
        return seq.batch_slot

    def free_slot(self, seq):
        """Release a sequence's batch slot.  Its row is deactivated at the next
        dispatch (``_flush_deactivations``): this may run on the event-loop thread
        while a step runs on the worker thread, and a row left active would keep
        writing KV through its stale table into freed blocks."""
        if seq.batch_slot >= 0:
            self._pending_deactivate.add(seq.batch_slot)
            heapq.heappush(self._free_slots, seq.batch_slot)
            seq.batch_slot = -1

    def _flush_deactivations(self):
        if self._pending_deactivate:
            slots = sorted(self._pending_deactivate)
            self.deactivate_rows(slots)
            self._pending_deactivate.difference_update(slots)

    # -- one step over a padded batch -------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.device)

    def _run(self, seqs, chunk_starts, chunk_lens, count_inputs: bool,
             valid, reset) -> StepOutput:
        """Compose a padded batch from sequences and run one step (prefill chunk,
        or decode with start = num_computed and len 1)."""
        with self._on_stream():
            return self._run_step(seqs, chunk_starts, chunk_lens, count_inputs, valid,
                                  reset)

    def _run_step(self, seqs, chunk_starts, chunk_lens, count_inputs, valid, reset):
        n = len(seqs)
        B = bucketize(n, self.batch_buckets)
        T = bucketize(max(chunk_lens), self.chunk_buckets) if count_inputs else 1
        bs = self.cache_config.block_size
        max_ctx_blocks = max((s.num_computed_tokens + ln + bs - 1) // bs
                             for s, ln in zip(seqs, chunk_lens))
        W = bucketize(max_ctx_blocks, self.table_buckets)

        input_ids = np.zeros((B, T), np.int32)
        positions = np.zeros((B, T), np.int32)
        block_tables = np.zeros((B, W), np.int32)
        history_lens = np.zeros(B, np.int32)
        q_lens = np.zeros(B, np.int32)
        slot_rows = np.full(B, self.max_batch, np.int64)   # garbage row for padding
        adapter_ids = np.zeros(B, np.int32)                # S-LoRA slot, 0 for none
        reset_rows = np.zeros(B, bool)
        counts_reset = np.zeros(B, bool)
        valid_mask = np.zeros(B, bool)
        ssm_restores = []
        for i, (seq, start, length) in enumerate(zip(seqs, chunk_starts, chunk_lens)):
            input_ids[i, :length] = seq.history_ids[start:start + length]
            positions[i, :length] = np.arange(start, start + length)
            nb = min(len(seq.logical_blocks), W)
            block_tables[i, :nb] = seq.logical_blocks[:nb]
            history_lens[i] = start
            q_lens[i] = length
            slot_rows[i] = self.assign_slot(seq)
            adapter_ids[i] = getattr(seq, 'adapter_slot', 0)
            # a hybrid model's first chunk zeroes the slot's linear state
            reset_rows[i] = reset[i]
            # a seq's first chunk in its current lifetime clears the slot's
            # previous occupant's penalty counts (even after a prefix-cache hit)
            counts_reset[i] = reset[i] or (count_inputs and
                                           getattr(seq, '_fresh_counts', False))
            if count_inputs:
                seq._fresh_counts = False
            valid_mask[i] = valid[i]
            snap = getattr(seq, '_ssm_restore', None)
            if snap is not None:
                ssm_restores.append((int(slot_rows[i]), snap))
                seq._ssm_restore = None

        sampling = _pad_sampling(SamplingInputs.from_seqs(seqs, self.model_config.vocab_size),
                                 n, B)
        fresh = count_inputs and all(s == 0 for s in chunk_starts)
        self._flush_deactivations()
        if ssm_restores:
            self._apply_ssm_restores(ssm_restores)
        with torch.no_grad():
            dev = self._to_dev
            slots = dev(slot_rows)
            meta = AttnMeta(block_tables=dev(block_tables),
                            history_lens=dev(history_lens), q_lens=dev(q_lens))
            if self.has_linear_state:
                meta.slot_rows, meta.reset_rows = slots, dev(reset_rows)
            ids = dev(input_ids)
            logits = self.model.forward(self.params, ids, dev(positions), self.kv_cache,
                                        meta, self.rope_cos, self.rope_sin,
                                        fresh_prefill=fresh,
                                        **self._adapter_kw(lambda: dev(adapter_ids)))
            reset_t = dev(counts_reset)[:, None]
            rows = torch.where(reset_t, torch.zeros_like(self.token_counts[slots]),
                               self.token_counts[slots])
            prows = self.prompt_mask[slots] & ~reset_t
            if count_inputs:
                # prompt tokens feed the repetition penalty only (prompt mask);
                # frequency/presence count generated tokens only
                V = self.model_config.vocab_size
                hits = torch.zeros((B, V), dtype=torch.int32, device=self.device)
                t_valid = (torch.arange(T, device=self.device)[None, :]
                           < meta.q_lens[:, None]).int()
                hits.scatter_add_(1, ids.long().clamp(0, V - 1), t_valid)
                prows = prows | (hits > 0)
            tokens, logprob, top = sample_logits(logits, sampling.to(self.device), rows,
                                                 prows, full_vocab=True)
            update_token_counts(rows, tokens, dev(valid_mask))
            self.token_counts[slots] = rows
            if count_inputs:
                self.prompt_mask[slots] = prows
        return StepOutput(tokens, logprob, top if sampling.max_top_logprobs else None)

    # -- public step API --------------------------------------------------------------
    def prefill(self, chunks) -> StepOutput:
        """One prefill step over scheduler PrefillChunks."""
        return self._run([c.seq for c in chunks], [c.start for c in chunks],
                         [c.length for c in chunks], count_inputs=True,
                         valid=[c.is_last for c in chunks],
                         reset=[c.start == 0 for c in chunks])

    def decode(self, seqs) -> StepOutput:
        """One decode step over RUNNING sequences (input = last token)."""
        return self._run(seqs, [s.num_token_ids - 1 for s in seqs], [1] * len(seqs),
                         count_inputs=False, valid=[True] * len(seqs),
                         reset=[False] * len(seqs))

    # -- linear-attention state snapshots (engine/ssm_ckpt.py) ------------------------
    def _state_keys(self) -> List[str]:
        cache = self.kv_cache
        return [k for k in cache if k != 'pages'] if isinstance(cache, dict) else []

    def snapshot_slot_state(self, slot: int) -> dict:
        """One slot's state rows (``conv`` [n_lin, K-1, C], ``rec`` [n_lin, Hv, dk,
        dv]) as host tensors, copied on the agent's stream after the steps queued
        before (reference :680-692)."""
        with self._on_stream():
            snap = {k: _host_copy(self.kv_cache[k][:, slot]) for k in self._state_keys()}
            if self.stream is not None:
                self.stream.synchronize()
        return snap

    def _apply_ssm_restores(self, restores):
        """Write host snapshots into their slots' state rows, in place, on the agent's
        stream before the step that reads them (reference :694-708)."""
        for slot, snap in restores:
            for k in self._state_keys():
                self.kv_cache[k][:, slot].copy_(snap[k], non_blocking=True)

    # -- device-resident decode state -------------------------------------------------
    def insert_decode_rows(self, seqs):
        """Write these RUNNING seqs' rows into the device decode state."""
        if not seqs:
            return
        with self._on_stream():
            self.ensure_table_width(max(len(s.logical_blocks) for s in seqs))
            rows = host_rows_from_seqs(seqs, self.state_table_width)
            idx = np.asarray([self.assign_slot(s) for s in seqs], np.int64)
            self.decode_state.insert_rows(idx, rows)

    def deactivate_rows(self, slots):
        if slots:
            with self._on_stream():
                self.decode_state.insert_rows(np.asarray(slots, np.int64),
                                              {'active': np.zeros(len(slots), bool)})

    def update_tables(self, seqs):
        """Refresh table rows after block allocation."""
        if not seqs:
            return
        with self._on_stream():
            self.ensure_table_width(max(len(s.logical_blocks) for s in seqs))
            W = self.state_table_width
            tables = np.zeros((len(seqs), W), np.int32)
            for i, s in enumerate(seqs):
                nb = min(len(s.logical_blocks), W)
                tables[i, :nb] = s.logical_blocks[:nb]
            self.decode_state.insert_rows(
                np.asarray([s.batch_slot for s in seqs], np.int64), {'tables': tables})

    def ensure_table_width(self, needed: int):
        """Grow the state's block-table width to the next bucket.  A grown table is a
        new tensor, so every captured decode run (and speculative step) is dropped (the tables start at full
        width, so this does not happen while serving)."""
        if needed <= self.state_table_width:
            return
        new_w = bucketize(needed, self.table_buckets)
        old = self.decode_state.tables
        grown = torch.zeros((old.shape[0], new_w), dtype=old.dtype, device=old.device)
        grown[:, :old.shape[1]] = old
        self.decode_state.tables = grown
        self.state_table_width = new_w
        self.graphs.clear()

    # -- decode runs ------------------------------------------------------------------
    @torch.no_grad()
    def decode_run(self, num_rows: int, k: Optional[int] = None, simple: bool = False,
                   top_lp: int = 0, kmax: int = TOPK_CANDIDATES,
                   full_vocab: bool = False) -> StepOutput:
        """Dispatch k decode steps over rows [0, num_rows) of the decode state.

        Capacity (blocks and table rows) for k more tokens per row must already be
        ensured by the caller.  ``simple`` is the greedy fast path (every active row
        greedy with neutral penalties); ``top_lp`` > 0 also returns the per-step
        top-``top_lp`` logprobs; ``kmax`` widens the top-k/p candidate set.  On the
        card the run replays its key's graph (``graph_runner.py``), unless
        ``eager_mode`` or ``eager_reason`` says otherwise.  Returns tokens [k, B]."""
        k = k or self.decode_run_steps
        B = bucketize(num_rows, self.batch_buckets)
        with self._on_stream():
            self._flush_deactivations()
            run = self.graphs.run((k, B, simple, top_lp, kmax, full_vocab))
            return StepOutput(run.tokens, run.logprobs, run.top)

    def run_keys(self) -> List[RunKey]:
        """The decode-run keys built so far (the reference's ``'run'`` step fns)."""
        return list(self.graphs.runs)

    def _decode_body(self, run: DecodeRun, scratch: bool = False):
        """k decode steps of ``run.key`` into ``run``'s outputs, over the decode state
        or, with ``scratch``, one step over a state of B inactive rows of its own (a
        pass at the run's shapes that leaves the real state and cache as they were:
        inactive rows write only the padding block and add nothing to the penalty
        counts)."""
        k, B, simple, top_lp, kmax, full_vocab = run.key
        st: DecodeState = self.decode_state
        if scratch:
            k = 1
            st = make_initial_state(B, self.state_table_width, self.token_counts,
                                    self.prompt_mask)
        row = {n: getattr(st, n)[:B] for n in DecodeState.ROW_FIELDS}
        counts, pmask = st.token_counts[:B], st.prompt_mask[:B]
        with torch.no_grad():
            for i in range(k):
                act = row['active']
                q_lens = act.int()
                meta = AttnMeta(block_tables=row['tables'], history_lens=row['position'],
                                q_lens=q_lens)
                positions = row['position'].clamp(0, self.max_model_len - 1)[:, None]
                logits = self.model.forward(self.params, row['token'][:, None], positions,
                                            self.kv_cache, meta, self.rope_cos,
                                            self.rope_sin,
                                            **self._adapter_kw(lambda: row['adapter_id']))
                if simple:
                    tokens = torch.argmax(logits, dim=-1).int()
                    lp_all = torch.log_softmax(logits, dim=-1)
                    lp = torch.gather(lp_all, 1, tokens.long()[:, None])[:, 0]
                    top = torch.topk(lp_all, top_lp, dim=-1) if top_lp > 0 else None
                    top = None if top is None else (top.values, top.indices.int())
                else:
                    si = SamplingInputs(
                        temperature=row['temperature'], top_k=row['top_k'],
                        top_p=row['top_p'], min_p=row['min_p'],
                        repetition_penalty=row['repetition_penalty'],
                        frequency_penalty=row['frequency_penalty'],
                        presence_penalty=row['presence_penalty'],
                        do_sample=row['do_sample'],
                        seeds=(row['seed'] + (row['step_no'].long() + 1) * GOLDEN)
                        & 0xFFFFFFFF,
                        max_top_logprobs=top_lp)
                    tokens, lp, top = sample_logits(logits, si, counts, pmask, kmax=kmax,
                                                    full_vocab=full_vocab)
                    update_token_counts(counts, tokens, act)
                new_token = torch.where(act, tokens, row['token'])
                row['token'].copy_(new_token)
                row['position'].add_(q_lens)
                row['step_no'].add_(q_lens)
                run.tokens[i].copy_(new_token)
                run.logprobs[i].copy_(lp)
                if top_lp > 0:
                    run.top[0][i].copy_(top[0])
                    run.top[1][i].copy_(top[1])

    @torch.no_grad()
    def warmup(self, batch_sizes: Optional[List[int]] = None, decode_ks=None,
               prefill_tokens: Optional[List[int]] = None):
        """Build the hot decode runs ahead of time (reference ``warmup``: the greedy
        and the sampled variant of every power-of-two run length up to
        ``decode_run_steps``, for each batch size's bucket; under speculative decoding the
        speculative step instead), largest bucket first: on the card each is captured, on
        the CPU (or with ``eager_mode``) its buffers are made.  Each ``prefill_tokens`` chunk bucket runs one eager prefill step over
        padding rows, which builds its kernels and warms the allocator.  Call it before
        any request holds a batch slot."""
        if len(self._free_slots) != self.max_batch:
            raise RuntimeError('warmup runs before any sequence holds a batch slot')
        if decode_ks is None:
            decode_ks, k = [], 1
            while k <= self.decode_run_steps:
                decode_ks.append(k)
                k *= 2
        buckets = sorted({bucketize(b, self.batch_buckets)
                          for b in (batch_sizes or [self.max_batch])}, reverse=True)
        with self._on_stream():
            if self.spec is not None:
                # under speculative decoding the decode-state rows run speculative steps
                self.spec.warmup(buckets)
                buckets = []
            for B in buckets:
                for k in sorted(decode_ks, reverse=True):
                    for simple in (True, False):
                        self.graphs.prepare((k, B, simple, 0, TOPK_CANDIDATES, False))
            for tok in prefill_tokens or []:
                self._warm_prefill(bucketize(tok, self.chunk_buckets))

    # -- logits / ppl / reward scores (reference :1030-1083) --------------------------
    @torch.no_grad()
    def compute_logits(self, token_ids: List[int], block_ids: List[int]) -> np.ndarray:
        """Full-vocab f32 logits [n, V] of every position of one sequence (a reward
        model's [n, 1] scores), for the ppl and reward paths.  The caller lends
        scratch blocks for its KV and frees them after."""
        out = []
        self._score_chunks(token_ids, block_ids, lambda lg, start: out.append(lg.cpu()))
        return torch.cat(out).numpy()

    @torch.no_grad()
    def compute_nll(self, token_ids: List[int], block_ids: List[int]) -> np.ndarray:
        """The float64 negative log-likelihoods [n - 1] of tokens 1..n-1, each under
        the logits of the position before it: the reference's numpy log-sum-exp
        (``serve/async_engine.py:355-363``), taken on the agent's device so that only
        these values, not the [n, V] logits, reach the host."""
        n = len(token_ids)
        with self._on_stream():
            targets = self._to_dev(np.asarray(token_ids[1:], np.int64))
            nll = torch.zeros(max(n - 1, 0), dtype=torch.float64, device=self.device)

            def take(logits, start):
                rows = min(logits.shape[0], n - 1 - start)
                if rows > 0:
                    nll[start:start + rows] = nll_f64(logits[:rows],
                                                      targets[start:start + rows])
            self._score_chunks(token_ids, block_ids, take)
            return nll.cpu().numpy()

    def _score_chunks(self, token_ids: List[int], block_ids: List[int], take):
        """Run one sequence through ``block_ids`` in chunks of the largest chunk
        bucket, each at positions from its start over a history of its start (the
        reference's streaming through the cache), and hand each chunk's [cn, V] f32
        logits and start to ``take``, all on the agent's stream after whatever it
        queued before.  The first chunk is a fresh prefill (``flash_prefill``), later
        ones attend over the cache.  The page table is the request's own, so the
        decode graphs keep theirs; a hybrid model's state runs in the garbage slot,
        zeroed by the first chunk, so no batch slot's live state is read or written."""
        n = len(token_ids)
        bs = self.cache_config.block_size
        if n > self.max_model_len:
            raise ValueError(f'{n} tokens exceed the session length {self.max_model_len}')
        if len(block_ids) * bs < n:
            raise ValueError(f'{len(block_ids)} blocks of {bs} cannot hold {n} tokens')
        W = bucketize(max(len(block_ids), 1), self.table_buckets)
        table = np.zeros((1, W), np.int32)
        table[0, :len(block_ids)] = block_ids
        cap = max(self.chunk_buckets)
        dev = self._to_dev
        with self._on_stream():
            tables = dev(table)
            for start in range(0, n, cap):
                chunk = token_ids[start:start + cap]
                cn = len(chunk)
                T = bucketize(cn, self.chunk_buckets)
                ids = np.zeros((1, T), np.int32)
                ids[0, :cn] = chunk
                pos = np.zeros((1, T), np.int32)
                pos[0, :cn] = np.arange(start, start + cn)
                meta = AttnMeta(block_tables=tables,
                                history_lens=dev(np.asarray([start], np.int32)),
                                q_lens=dev(np.asarray([cn], np.int32)))
                if self.has_linear_state:
                    meta.slot_rows = dev(np.asarray([self.max_batch], np.int64))
                    meta.reset_rows = dev(np.asarray([start == 0]))
                logits = self.model.forward(
                    self.params, dev(ids), dev(pos), self.kv_cache, meta, self.rope_cos,
                    self.rope_sin, return_all_logits=True, fresh_prefill=start == 0,
                    **self._adapter_kw(lambda: dev(np.zeros(1, np.int32))))
                take(logits[0, :cn], start)

    def _warm_prefill(self, T: int):
        """One fresh prefill step of T-token chunks over padding rows (block table 0,
        the reserved padding block), its logits discarded."""
        B = bucketize(min(self.sched_config.max_prefill_batch, self.max_batch),
                      self.batch_buckets)
        W = bucketize(max(1, -(-T // self.cache_config.block_size)), self.table_buckets)
        dev = self.token_counts.device
        pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
        meta = AttnMeta(block_tables=torch.zeros((B, W), dtype=torch.int32, device=dev),
                        history_lens=torch.zeros(B, dtype=torch.int32, device=dev),
                        q_lens=torch.full((B,), T, dtype=torch.int32, device=dev))
        if self.has_linear_state:
            # padding rows: their state goes to the garbage slot
            meta.slot_rows = torch.full((B,), self.max_batch, dtype=torch.long, device=dev)
        self.model.forward(self.params, torch.zeros((B, T), dtype=torch.int32, device=dev),
                           pos.contiguous(), self.kv_cache, meta, self.rope_cos,
                           self.rope_sin, fresh_prefill=True)


# the bytes of f64 logits one tile of nll_f64 widens at most
NLL_TILE_BYTES = 512 << 20


def nll_f64(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits [R, V] (f32), targets [R] -> float64 [R] ``lse(row) - row[target]``,
    each row widened to float64 first, ``lse = log(sum(exp(row - max))) + max``; the
    rows go through in tiles of ``NLL_TILE_BYTES``."""
    R, V = logits.shape
    out = torch.empty(R, dtype=torch.float64, device=logits.device)
    tile = max(1, NLL_TILE_BYTES // (8 * V))
    for i in range(0, R, tile):
        lg = logits[i:i + tile].double()
        m = lg.amax(-1, keepdim=True)
        lse = torch.log(torch.exp(lg - m).sum(-1)) + m[:, 0]
        out[i:i + tile] = lse - lg.gather(1, targets[i:i + tile, None])[:, 0]
    return out


def _pad_sampling(s: SamplingInputs, n: int, B: int) -> SamplingInputs:
    if n == B:
        return s
    pad = B - n

    def pad1(x, fill):
        return np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])

    return SamplingInputs(
        temperature=pad1(s.temperature, 1.0), top_k=pad1(s.top_k, 0),
        top_p=pad1(s.top_p, 1.0), min_p=pad1(s.min_p, 0.0),
        repetition_penalty=pad1(s.repetition_penalty, 1.0),
        frequency_penalty=pad1(s.frequency_penalty, 0.0),
        presence_penalty=pad1(s.presence_penalty, 0.0),
        do_sample=pad1(s.do_sample, False), seeds=pad1(s.seeds, 0),
        bad_words_mask=None if s.bad_words_mask is None
        else pad1(s.bad_words_mask, False),
        max_top_logprobs=s.max_top_logprobs)
