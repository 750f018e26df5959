"""AsyncEngine: request orchestrator above the backend engine.

Port of ``lmdeploy_tpu/serve/async_engine.py``: chat-template application,
tokenization, engine streaming, incremental detokenization, stop-word string matching
and the session lifecycle.  Images, logits / ppl and reward scores come with the
slices that port them.
"""
from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Any, AsyncIterator, Dict, List, Literal, Optional, Union

from ..chat_template import ChatTemplateConfig, get_chat_template
from ..engine.engine import Engine
from ..messages import (GenerationConfig, Response, ResponseType,
                        TpuEngineConfig)
from ..tokenizer import DetokenizeState, Tokenizer


@dataclasses.dataclass
class GenOut:
    """One streamed generation delta (reference: async_engine.py:43)."""

    response: str
    history_token_len: int
    input_token_len: int
    generate_token_len: int
    finish_reason: Optional[Literal['stop', 'length', 'error', 'abort']] = None
    token_ids: Optional[List[int]] = None
    logprobs: Optional[List[Dict[int, float]]] = None
    logits: Any = None
    last_hidden_state: Any = None
    index: int = 0


class AsyncEngine:

    def __init__(self, model_path: str,
                 backend_config: Optional[TpuEngineConfig] = None,
                 chat_template_config: Optional[ChatTemplateConfig] = None,
                 device=None,
                 **kwargs):
        self.model_path = model_path
        self.backend_config = backend_config or TpuEngineConfig()
        self.tokenizer = Tokenizer(model_path)
        self.chat_template = get_chat_template(model_path, chat_template_config,
                                               self.tokenizer)
        self.engine = Engine.from_pretrained(model_path,
                                             engine_config=self.backend_config,
                                             tokenizer=self.tokenizer, device=device)
        self.instance = self.engine.create_instance()
        self._session_counter = 0
        self.stop_words: List[str] = list(getattr(self.chat_template, 'stop_words',
                                                  None) or [])

    # -- session helpers ---------------------------------------------------------------
    def next_session_id(self) -> int:
        self._session_counter += 1
        return self._session_counter

    async def stop_session(self, session_id: int):
        await self.instance.async_cancel(session_id)

    async def end_session(self, session_id: int):
        await self.instance.async_end(session_id)

    # -- prompt processing -------------------------------------------------------------
    def _get_prompt_input(self, prompt: Union[str, List[Dict]], do_preprocess: bool,
                          sequence_start: bool, chat_template=None) -> Dict[str, Any]:
        chat_template = chat_template or self.chat_template
        if do_preprocess:
            if isinstance(prompt, str):
                text = chat_template.get_prompt(prompt, sequence_start)
            else:
                text = chat_template.messages2prompt(prompt, sequence_start)
        else:
            if not isinstance(prompt, str):
                raise TypeError('a prompt without preprocessing must be a string')
            text = prompt
        input_ids = self.tokenizer.encode(text, add_bos=sequence_start)
        return {'prompt': text, 'input_ids': input_ids}

    # -- generation --------------------------------------------------------------------
    async def generate(
        self,
        messages: Union[str, List[Dict]],
        session_id: int,
        gen_config: Optional[GenerationConfig] = None,
        stream_response: bool = True,
        sequence_start: bool = True,
        sequence_end: bool = True,
        do_preprocess: bool = True,
        skip_stop_tokens: bool = True,
        **kwargs,
    ) -> AsyncIterator[GenOut]:
        """Stream GenOut deltas for one request (reference: async_engine.py:471)."""
        gen_config = gen_config or GenerationConfig()
        gen_config = dataclasses.replace(gen_config)
        gen_config.convert_stop_bad_words_to_ids(self.tokenizer)
        if gen_config.random_seed is None:
            gen_config.random_seed = random.getrandbits(32)
        # engine-level stop words from the chat template
        for w in self.stop_words:
            ids = self.tokenizer.encode(w, add_bos=False, add_special_tokens=False)
            if len(ids) == 1:
                st = gen_config.stop_token_ids or []
                if ids[0] not in st:
                    gen_config.stop_token_ids = st + [ids[0]]

        prompt_input = self._get_prompt_input(messages, do_preprocess, sequence_start)
        input_ids = prompt_input['input_ids']
        state = DetokenizeState()
        prev_len = 0
        finish_reason = None
        text_cache = ''

        async for out in self.instance.async_stream_infer(
                session_id, input_ids, gen_config):
            ids = out.token_ids
            if out.status == ResponseType.FINISH:
                finish_reason = 'length' if len(ids) >= gen_config.max_new_tokens \
                    else 'stop'
            elif out.status == ResponseType.CANCEL:
                finish_reason = 'abort'
            elif out.status != ResponseType.SUCCESS:
                finish_reason = 'error'

            new_text, state = self.tokenizer.detokenize_incrementally(
                ids, state, skip_special_tokens=gen_config.skip_special_tokens,
                spaces_between_special_tokens=gen_config.spaces_between_special_tokens)
            text_cache += new_text
            emit_text, text_cache, hit_stop = self._filter_stop_str(
                text_cache, final=finish_reason is not None)
            if hit_stop and finish_reason is None:
                finish_reason = 'stop'
                await self.stop_session(session_id)

            is_final = finish_reason is not None
            if emit_text or is_final:
                lps = None
                if out.logprobs is not None:
                    lps = out.logprobs[prev_len:len(ids)]
                yield GenOut(response=emit_text,
                             history_token_len=0,
                             input_token_len=len(input_ids),
                             generate_token_len=len(ids),
                             finish_reason=finish_reason,
                             token_ids=list(ids[prev_len:]),
                             logprobs=lps)
                prev_len = len(ids)
            if is_final:
                break

        if sequence_end:
            await self.end_session(session_id)

    def _filter_stop_str(self, text: str, final: bool):
        """Hold back text that could be a prefix of a multi-token stop word."""
        if not self.stop_words:
            return text, '', False
        for w in self.stop_words:
            idx = text.find(w)
            if idx >= 0:
                return text[:idx], '', True
        if final:
            return text, '', False
        # retain the longest suffix that prefixes any stop word
        max_hold = max(len(w) for w in self.stop_words) - 1
        hold = 0
        for k in range(1, min(max_hold, len(text)) + 1):
            suffix = text[-k:]
            if any(w.startswith(suffix) for w in self.stop_words):
                hold = k
        if hold:
            return text[:-hold], text[-hold:], False
        return text, '', False

    # -- batch / sync helpers ----------------------------------------------------------
    async def _one_request(self, prompt, gen_config, do_preprocess=True,
                           index: int = 0) -> Response:
        session_id = self.next_session_id()
        text = ''
        token_ids: List[int] = []
        logprobs = []
        finish_reason = None
        input_len = 0
        async for out in self.generate(prompt, session_id, gen_config=gen_config,
                                       do_preprocess=do_preprocess):
            text += out.response
            token_ids.extend(out.token_ids or [])
            if out.logprobs:
                logprobs.extend(out.logprobs)
            finish_reason = out.finish_reason
            input_len = out.input_token_len
        return Response(text=text, generate_token_len=len(token_ids),
                        input_token_len=input_len, finish_reason=finish_reason,
                        token_ids=token_ids, logprobs=logprobs or None,
                        index=index)

    async def async_batch_infer(self, prompts, gen_config=None, do_preprocess=True,
                                **kwargs) -> List[Response]:
        is_single = isinstance(prompts, str) or (
            isinstance(prompts, list) and prompts and isinstance(prompts[0], dict))
        batch = [prompts] if is_single else list(prompts)
        if gen_config is None:
            gen_config = GenerationConfig()
        cfgs = gen_config if isinstance(gen_config, list) else [gen_config] * len(batch)
        tasks = [self._one_request(p, c, do_preprocess, i)
                 for i, (p, c) in enumerate(zip(batch, cfgs))]
        results = await asyncio.gather(*tasks)
        return results[0] if is_single else list(results)

    def close(self):
        self.engine.close()
