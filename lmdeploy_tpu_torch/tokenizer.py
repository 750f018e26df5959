"""HF tokenizer wrapper with incremental detokenization.

Reference analog: ``lmdeploy/tokenizer.py`` (Tokenizer ``:419``, DetokenizeState ``:16``,
``detokenize_incrementally:502``).  Incremental detokenization is a host-side state machine:
it re-decodes a short suffix window each step and only emits text once the trailing bytes
form complete UTF-8 / complete sentencepiece words, so streamed output never shows
replacement characters mid-glyph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass
class DetokenizeState:
    """Carries the incremental-detokenization cursor between steps."""

    ids_offset: int = 0
    prev_tokens: Optional[List[str]] = None
    prefix_offset: int = 0
    read_offset: int = 0

    def as_tuple(self) -> Tuple:
        return (self.ids_offset, self.prev_tokens, self.prefix_offset, self.read_offset)


class Tokenizer:
    """Thin wrapper over a HF fast tokenizer with helpers the engine needs."""

    def __init__(self, model_path: str, trust_remote_code: bool = True):
        from transformers import AutoTokenizer
        self.model = AutoTokenizer.from_pretrained(model_path,
                                                   trust_remote_code=trust_remote_code)
        self._no_prefix_space_tokens = None
        self._indexes_tokens_deque: dict = {}

    # -- basic surface ---------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.model)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self.model.bos_token_id

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.model.eos_token_id

    def encode(self, s: str, add_bos: bool = True, add_special_tokens: bool = True,
               **kwargs) -> List[int]:
        encoded = self.model.encode(s, add_special_tokens=add_special_tokens, **kwargs)
        if not add_bos and self.bos_token_id is not None and encoded \
                and encoded[0] == self.bos_token_id:
            encoded = encoded[1:]
        return encoded

    def decode(self, t: Sequence[int], offset: Optional[int] = None,
               skip_special_tokens: bool = True) -> str:
        t = list(t)
        if offset:
            t = t[offset:]
        return self.model.decode(t, skip_special_tokens=skip_special_tokens)

    def __call__(self, s):
        return self.model(s)

    def indexes_containing_token(self, token: str) -> List[int]:
        """All vocab ids whose decoded text contains ``token`` exactly.

        Used to resolve stop words into token ids (reference: tokenizer.py:470).
        A full vocab scan is O(V); cache per token.
        """
        if token in self._indexes_tokens_deque:
            return self._indexes_tokens_deque[token]
        enc = self.model.encode(token, add_special_tokens=False)
        indexes: List[int] = []
        if len(enc) == 1:
            indexes.append(enc[0])
        else:
            # multi-token stop words are matched at the string level by the engine
            indexes = enc[-1:]
        self._indexes_tokens_deque[token] = indexes
        return indexes

    # -- incremental detokenization ---------------------------------------------------
    def detokenize_incrementally(self, all_input_ids: Sequence[int], state: DetokenizeState,
                                 skip_special_tokens: bool = True,
                                 spaces_between_special_tokens: bool = True
                                 ) -> Tuple[str, DetokenizeState]:
        """Decode newly generated ids, returning only newly finalized text.

        Maintains a (prefix_offset, read_offset) window: text between the two offsets was
        already emitted; new text is emitted only when decoding past read_offset yields a
        string that does not end in an incomplete UTF-8 sequence (U+FFFD).
        """
        tokenizer = self.model
        ids = list(all_input_ids)

        if state.prev_tokens is None:
            # First call: every id passed is newly generated — emit all of it.
            new_tokens = tokenizer.convert_ids_to_tokens(
                ids, skip_special_tokens=skip_special_tokens)
            # skip None (skipped special tokens may return None entries)
            output_tokens = [t for t in new_tokens if t is not None]
            prefix_offset = 0
            read_offset = 0
        else:
            new_ids = ids[state.ids_offset:]
            new_tokens = tokenizer.convert_ids_to_tokens(
                new_ids, skip_special_tokens=skip_special_tokens)
            new_tokens = [t for t in new_tokens if t is not None]
            output_tokens = state.prev_tokens + new_tokens
            prefix_offset = state.prefix_offset
            read_offset = state.read_offset

        prefix_text = self._convert_tokens_to_string(
            output_tokens[prefix_offset:read_offset],
            skip_special_tokens, spaces_between_special_tokens)
        new_text = self._convert_tokens_to_string(
            output_tokens[prefix_offset:],
            skip_special_tokens, spaces_between_special_tokens)

        if len(new_text) > len(prefix_text) and not new_text.endswith('�'):
            emitted = new_text[len(prefix_text):]
            new_state = DetokenizeState(
                ids_offset=len(ids),
                prev_tokens=output_tokens,
                prefix_offset=read_offset,
                read_offset=len(output_tokens))
            return emitted, new_state

        new_state = DetokenizeState(
            ids_offset=len(ids),
            prev_tokens=output_tokens,
            prefix_offset=prefix_offset,
            read_offset=read_offset)
        return '', new_state

    def _convert_tokens_to_string(self, tokens: List[str], skip_special_tokens: bool,
                                  spaces_between_special_tokens: bool) -> str:
        if not tokens:
            return ''
        tokenizer = self.model
        special = set(tokenizer.all_special_tokens)
        added_vocab = tokenizer.get_added_vocab()
        sub_texts: List[str] = []
        current: List[str] = []
        for token in tokens:
            if skip_special_tokens and token in special:
                continue
            if token in added_vocab:
                if current:
                    sub_texts.append(tokenizer.convert_tokens_to_string(current))
                    current = []
                sub_texts.append(token)
            else:
                current.append(token)
        if current:
            sub_texts.append(tokenizer.convert_tokens_to_string(current))
        if spaces_between_special_tokens:
            return ' '.join(sub_texts) if any(t in added_vocab for t in tokens) \
                else ''.join(sub_texts)
        return ''.join(sub_texts)
