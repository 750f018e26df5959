"""Scheduler-side sequence/session state.

Reference analog: ``lmdeploy/pytorch/messages.py`` (SchedulerSession/SchedulerSequence,
token history arrays, logical blocks) and ``seq_states/states.py`` (status machine).
Copy of ``lmdeploy_tpu/paging/seq.py`` for the PyTorch port (host-only code).
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..messages import GenerationConfig


class MessageStatus(enum.Enum):
    WAITING = enum.auto()    # admitted, needs (more) prefill
    RUNNING = enum.auto()    # in the decode batch
    STOPPED = enum.auto()    # finished/aborted, pending cleanup
    ENDED = enum.auto()      # resources released


_SEQ_COUNT = 0


def _next_seq_id() -> int:
    global _SEQ_COUNT
    _SEQ_COUNT += 1
    return _SEQ_COUNT


@dataclass
class SamplingParams:
    """Flattened per-sequence sampling parameters for device-side batching."""

    temperature: float = 1.0
    top_k: int = 0           # 0 = disabled
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    do_sample: bool = False
    random_seed: int = 0
    stop_token_ids: List[int] = field(default_factory=list)
    bad_token_ids: List[int] = field(default_factory=list)
    max_new_tokens: int = 512
    min_new_tokens: int = 0
    ignore_eos: bool = False
    logprobs: int = -1       # -1 disabled, else top-k logprobs to return
    response_format: Optional[dict] = None   # {'type': 'json_object'} guided decoding
    adapter_name: Optional[str] = None       # S-LoRA adapter for this request

    @classmethod
    def from_gen_config(cls, gen_config: GenerationConfig, eos_token_ids: List[int],
                        seed: Optional[int] = None) -> 'SamplingParams':
        stop_ids = list(gen_config.stop_token_ids or [])
        if not gen_config.ignore_eos:
            stop_ids.extend(i for i in eos_token_ids if i not in stop_ids)
        do_sample = gen_config.do_sample or gen_config.temperature not in (None, 0.0)
        temperature = gen_config.temperature if gen_config.do_sample else \
            (gen_config.temperature or 1.0)
        if not gen_config.do_sample:
            # reference semantics: do_sample=False => greedy regardless of temperature
            do_sample = False
        return cls(
            temperature=max(temperature, 1e-6),
            top_k=gen_config.top_k or 0,
            top_p=gen_config.top_p,
            min_p=gen_config.min_p,
            repetition_penalty=gen_config.repetition_penalty,
            frequency_penalty=gen_config.frequency_penalty,
            presence_penalty=gen_config.presence_penalty,
            do_sample=do_sample,
            random_seed=seed if seed is not None else (gen_config.random_seed or 0),
            stop_token_ids=stop_ids,
            bad_token_ids=list(gen_config.bad_token_ids or []),
            max_new_tokens=gen_config.max_new_tokens,
            min_new_tokens=gen_config.min_new_tokens or 0,
            ignore_eos=gen_config.ignore_eos,
            logprobs=gen_config.logprobs if gen_config.logprobs is not None else -1,
            response_format=gen_config.response_format,
            adapter_name=getattr(gen_config, 'adapter_name', None),
        )


@dataclass
class SeqMetrics:
    arrival_time: float = 0.0
    first_scheduled_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0


class SchedulerSequence:
    """One generation stream: prompt + generated tokens + cache blocks."""

    def __init__(self, seq_id: int, session: 'SchedulerSession',
                 token_ids: List[int], sampling_params: SamplingParams):
        self.seq_id = seq_id
        self.session = session
        self.history_ids: np.ndarray = np.asarray(token_ids, dtype=np.int32)
        self.num_computed_tokens: int = 0      # tokens whose KV is in cache
        self.num_prompt_tokens: int = len(token_ids)
        self.output_ids: List[int] = []
        self.logical_blocks: List[int] = []    # physical block ids, in order
        self.status: MessageStatus = MessageStatus.WAITING
        self.sampling_params = sampling_params
        self.metrics = SeqMetrics(arrival_time=time.time())
        self.num_ignored_history: int = 0
        self.return_logits = False
        self.num_new_tokens: int = 0           # tokens generated but not yet emitted
        self.batch_slot: int = -1              # position in the device decode batch
        self.guided = None                     # guided-decoding state (guided.py)
        # multimodal embedding spans [(abs_offset, np [n, H])]; survive preemption
        # (re-prefill re-applies them at the same absolute positions)
        self.mm_spans: list = []
        self.adapter_slot: int = 0             # S-LoRA slot (0 = no adapter)
        self.num_window_freed: int = 0         # leading blocks freed (sliding window)
        self._fresh_counts = True              # penalty counts need a reset on the
        #                                        seq's first chunk (even when a trie
        #                                        match starts it at position > 0)

    # -- token accounting -------------------------------------------------------------
    @property
    def num_token_ids(self) -> int:
        return len(self.history_ids)

    @property
    def num_all_tokens(self) -> int:
        return self.num_token_ids

    @property
    def num_uncomputed(self) -> int:
        return self.num_token_ids - self.num_computed_tokens

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_ids)

    def append_token(self, token_id: int):
        self.history_ids = np.append(self.history_ids, np.int32(token_id))
        self.output_ids.append(int(token_id))

    def append_tokens(self, token_ids):
        """Bulk append (one concatenate — np.append per token is O(n^2)
        across a decode run)."""
        self.history_ids = np.concatenate(
            [self.history_ids, np.asarray(token_ids, np.int32)])
        self.output_ids.extend(int(t) for t in token_ids)

    def update_prompt(self, token_ids: List[int]):
        """Interactive multi-turn: extend the prompt of an existing sequence."""
        self.history_ids = np.concatenate(
            [self.history_ids, np.asarray(token_ids, dtype=np.int32)])
        self.num_prompt_tokens = len(self.history_ids)
        self.output_ids = []

    def reset_computed(self):
        """Preemption by recompute: cache dropped, must re-prefill everything.

        ``batch_slot`` (the device sampling-state row) is kept — it is owned until the
        sequence finishes; re-prefill resets the row contents via the reset flag.
        """
        self.num_computed_tokens = 0
        self.logical_blocks = []
        self.num_window_freed = 0
        self._fresh_counts = True


class SchedulerSession:
    """Session = a stateful conversation owning sequences (reference: messages.py)."""

    def __init__(self, session_id: int, block_size: int):
        self.session_id = session_id
        self.block_size = block_size
        self.sequences: Dict[int, SchedulerSequence] = {}
        self.status: MessageStatus = MessageStatus.RUNNING

    def add_sequence(self, token_ids: List[int],
                     sampling_params: SamplingParams) -> SchedulerSequence:
        seq = SchedulerSequence(_next_seq_id(), self, token_ids, sampling_params)
        self.sequences[seq.seq_id] = seq
        return seq


class SequenceManager:
    """Global registry of sessions/sequences keyed by status."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self.sessions: Dict[int, SchedulerSession] = {}

    def add_session(self, session_id: int) -> SchedulerSession:
        assert session_id not in self.sessions, f'session {session_id} exists'
        session = SchedulerSession(session_id, self.block_size)
        self.sessions[session_id] = session
        return session

    def get_session(self, session_id: int) -> Optional[SchedulerSession]:
        return self.sessions.get(session_id)

    def remove_session(self, session_id: int) -> Optional[SchedulerSession]:
        return self.sessions.pop(session_id, None)

    def all_sequences(self) -> List[SchedulerSequence]:
        out = []
        for sess in self.sessions.values():
            out.extend(sess.sequences.values())
        return out

    def seqs_with_status(self, status: MessageStatus) -> List[SchedulerSequence]:
        return [s for s in self.all_sequences() if s.status == status]
