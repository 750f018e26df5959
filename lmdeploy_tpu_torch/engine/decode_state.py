"""Device-resident decode state for multi-step decode runs.

Port of ``lmdeploy_tpu/engine/decode_state.py``.  Every per-step decode input (last
token, position, block table, sampling parameters, seen-token counts) lives in
device tensors; a decode run feeds each sampled token back on the device and the
host fetches one ``[k, B]`` token array per run.  The host writes rows only when
batch membership changes or a row needs a new cache block (``insert_rows``), in place,
so that every leaf keeps the storage the captured decode runs read.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class DecodeState:
    """All leaves ``[Bmax, ...]`` on one device, updated in place."""

    token: torch.Tensor          # [Bmax] i32 -- last sampled token per row
    position: torch.Tensor       # [Bmax] i32 -- tokens in cache for this row
    tables: torch.Tensor         # [Bmax, W] i32
    active: torch.Tensor         # [Bmax] bool
    step_no: torch.Tensor        # [Bmax] i32 -- per-row sampling step (seed folding)
    temperature: torch.Tensor    # [Bmax] f32
    top_k: torch.Tensor          # [Bmax] i32
    top_p: torch.Tensor          # [Bmax] f32
    min_p: torch.Tensor          # [Bmax] f32
    repetition_penalty: torch.Tensor  # [Bmax] f32
    frequency_penalty: torch.Tensor   # [Bmax] f32
    presence_penalty: torch.Tensor    # [Bmax] f32
    do_sample: torch.Tensor      # [Bmax] bool
    seed: torch.Tensor           # [Bmax] i64 holding a u32 seed
    adapter_id: torch.Tensor     # [Bmax] i32 -- S-LoRA slot (0 = none)
    token_counts: torch.Tensor   # [Bmax+1, V] i32 -- generated-token counts
    prompt_mask: torch.Tensor    # [Bmax+1, V] bool -- tokens present in the prompt

    ROW_FIELDS = ()              # filled below: the per-row leaves

    def insert_rows(self, idx: np.ndarray, rows: Dict[str, np.ndarray]):
        """Write host rows into the state at batch slots ``idx``, in place (every leaf
        keeps its storage, which the captured decode runs read), without waiting for
        the card."""
        index = to_device(np.asarray(idx, np.int64), self.token.device)
        for name, values in rows.items():
            leaf = getattr(self, name)
            leaf[index] = to_device(np.asarray(values), leaf.device, leaf.dtype)


def to_device(a: np.ndarray, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array as a tensor on ``device`` (in ``dtype``).  On a card the copy goes
    through pinned memory and is queued on the current stream, so the host does not
    wait for the steps queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


DecodeState.ROW_FIELDS = tuple(f.name for f in fields(DecodeState)
                               if f.name not in ('token_counts', 'prompt_mask'))


def make_initial_state(max_batch: int, table_width: int, token_counts: torch.Tensor,
                       prompt_mask: torch.Tensor) -> DecodeState:
    """Empty state; the penalty buffers are shared with the prefill path."""
    dev = token_counts.device

    def z(dt):
        return torch.zeros((max_batch,), dtype=dt, device=dev)

    def ones(dt):
        return torch.ones((max_batch,), dtype=dt, device=dev)

    return DecodeState(
        token=z(torch.int32), position=z(torch.int32),
        tables=torch.zeros((max_batch, table_width), dtype=torch.int32, device=dev),
        active=z(torch.bool), step_no=z(torch.int32),
        temperature=ones(torch.float32), top_k=z(torch.int32),
        top_p=ones(torch.float32), min_p=z(torch.float32),
        repetition_penalty=ones(torch.float32), frequency_penalty=z(torch.float32),
        presence_penalty=z(torch.float32), do_sample=z(torch.bool),
        seed=z(torch.int64), adapter_id=z(torch.int32), token_counts=token_counts, prompt_mask=prompt_mask)


def host_rows_from_seqs(seqs: List, table_width: int) -> Dict[str, np.ndarray]:
    """Per-row host arrays for inserting these RUNNING seqs into the state
    (last history token sampled, position = num_computed_tokens).  Penalty
    counts are not rebuilt: prefill already keeps them at the same slot."""
    n = len(seqs)
    out = {
        'token': np.zeros(n, np.int32),
        'position': np.zeros(n, np.int32),
        'tables': np.zeros((n, table_width), np.int32),
        'active': np.ones(n, bool),
        'step_no': np.zeros(n, np.int32),
        'temperature': np.ones(n, np.float32),
        'top_k': np.zeros(n, np.int32),
        'top_p': np.ones(n, np.float32),
        'min_p': np.zeros(n, np.float32),
        'repetition_penalty': np.ones(n, np.float32),
        'frequency_penalty': np.zeros(n, np.float32),
        'presence_penalty': np.zeros(n, np.float32),
        'do_sample': np.zeros(n, bool),
        'seed': np.zeros(n, np.int64),
        'adapter_id': np.zeros(n, np.int32),
    }
    for i, seq in enumerate(seqs):
        p = seq.sampling_params
        out['token'][i] = seq.history_ids[-1]
        out['position'][i] = seq.num_computed_tokens
        nb = min(len(seq.logical_blocks), table_width)
        out['tables'][i, :nb] = seq.logical_blocks[:nb]
        out['step_no'][i] = seq.num_output_tokens
        out['temperature'][i] = p.temperature
        out['top_k'][i] = p.top_k
        out['top_p'][i] = p.top_p
        out['min_p'][i] = p.min_p
        out['repetition_penalty'][i] = p.repetition_penalty
        out['frequency_penalty'][i] = p.frequency_penalty
        out['presence_penalty'][i] = p.presence_penalty
        out['do_sample'][i] = p.do_sample
        out['seed'][i] = (p.random_seed or 0) & 0xFFFFFFFF
        out['adapter_id'][i] = getattr(seq, 'adapter_slot', 0)
    return out
