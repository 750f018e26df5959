"""AsyncEngine: request orchestrator above the backend engine.

Port of ``lmdeploy_tpu/serve/async_engine.py``: chat-template application,
tokenization, engine streaming, incremental detokenization, stop-word string matching,
the session lifecycle with the servers' abort-all (``stop_all_sessions``), and the
scoring requests: logits, ppl and reward scores (``async_get_logits``,
``async_get_ppl``, ``async_get_reward_score``), each a prefill of scratch blocks on the
engine's device thread.  Image parts of a prompt are split off as the reference splits
them; the engine refuses them (multimodal inputs are not ported yet).
"""
from __future__ import annotations

import asyncio
import dataclasses
import random
from contextlib import asynccontextmanager
from typing import Any, AsyncIterator, Dict, List, Literal, Optional, Union

import numpy as np

from ..chat_template import ChatTemplateConfig, get_chat_template
from ..engine.engine import Engine
from ..messages import (GenerationConfig, Response, ResponseType, SpeculativeConfig,
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


class Session:
    """Client-side session handle for stateful chat."""

    def __init__(self, session_id: int, engine: 'AsyncEngine'):
        self.session_id = session_id
        self.engine = engine
        self.history: List[Dict[str, str]] = []
        self.step = 0


class AsyncEngine:

    def __init__(self, model_path: str,
                 backend_config: Optional[TpuEngineConfig] = None,
                 chat_template_config: Optional[ChatTemplateConfig] = None,
                 device=None,
                 speculative_config: Optional[SpeculativeConfig] = None,
                 **kwargs):
        self.model_path = model_path
        self.backend_config = backend_config or TpuEngineConfig()
        tokenizer = Tokenizer(model_path)
        chat_template = get_chat_template(model_path, chat_template_config, tokenizer)
        engine = Engine.from_pretrained(model_path, engine_config=self.backend_config,
                                        tokenizer=tokenizer, device=device,
                                        speculative_config=speculative_config)
        self._attach(engine, tokenizer, chat_template)

    @classmethod
    def from_engine(cls, engine: Engine, tokenizer=None,
                    chat_template=None) -> 'AsyncEngine':
        """An AsyncEngine over an ``Engine`` built already.  The scoring methods need
        neither a tokenizer nor a chat template; ``generate`` needs both."""
        self = cls.__new__(cls)
        self.model_path = None
        self.backend_config = engine.engine_config
        self._attach(engine, tokenizer, chat_template)
        return self

    def _attach(self, engine: Engine, tokenizer, chat_template):
        self.tokenizer = tokenizer
        self.chat_template = chat_template
        self.engine = engine
        self.instance = engine.create_instance()
        self._session_counter = 0
        # abort-all (reference :69-74): stop_all_sessions() bumps the epoch, and a
        # generate() bound to an older epoch aborts at its next turn even if it raced
        # the cancellation sweep
        self.epoch = 0
        self.stop_words: List[str] = list(getattr(chat_template, 'stop_words', None) or [])

    # -- session helpers ---------------------------------------------------------------
    def next_session_id(self) -> int:
        self._session_counter += 1
        return self._session_counter

    async def stop_session(self, session_id: int):
        await self.instance.async_cancel(session_id)

    async def stop_all_sessions(self):
        """Abort every in-flight request (reference :87-96)."""
        self.epoch += 1
        for sid in list(self.engine._requests.keys()):
            try:
                await self.instance.async_cancel(sid)
            except Exception:  # noqa: BLE001 — the session may have just finished
                pass

    async def end_session(self, session_id: int):
        await self.instance.async_end(session_id)

    @asynccontextmanager
    async def model_inst(self, session_id: int):
        yield self.instance

    # -- prompt processing -------------------------------------------------------------
    @property
    def _image_marker(self) -> str:
        return getattr(self.engine.model_agent.model, 'image_marker', '<image>')

    def _split_vl_inputs(self, prompt):
        """Split images off a prompt (reference :111-154): ``(text, image)`` /
        ``(text, [images])`` tuples, and OpenAI message lists whose content is a parts
        array (text parts joined, ``image_url`` / ``image_data`` parts taken out, one
        image marker each).  Returns (prompt, images)."""
        images: List = []
        if isinstance(prompt, tuple):
            text, imgs = prompt
            imgs = imgs if isinstance(imgs, (list, tuple)) else [imgs]
            images.extend(imgs)
            marker = self._image_marker
            if marker not in text:
                text = (marker + '\n') * len(imgs) + text
            return text, images
        if isinstance(prompt, list):
            out_msgs = []
            for m in prompt:
                content = m.get('content')
                if isinstance(content, list):
                    texts, n_imgs = [], 0
                    for part in content:
                        ptype = part.get('type')
                        if ptype == 'text':
                            texts.append(part.get('text', ''))
                        elif ptype == 'image_url':
                            url = part['image_url']
                            images.append(url.get('url') if isinstance(url, dict) else url)
                            n_imgs += 1
                        elif ptype == 'image_data':
                            images.append(part.get('data'))
                            n_imgs += 1
                    text = ''.join(texts)
                    marker = self._image_marker
                    if n_imgs and marker not in text:
                        text = (marker + '\n') * n_imgs + text
                    out_msgs.append({**m, 'content': text})
                else:
                    out_msgs.append(m)
            return out_msgs, images
        return prompt, images

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

        messages, mm_images = self._split_vl_inputs(messages)
        prompt_input = self._get_prompt_input(messages, do_preprocess, sequence_start)
        input_ids = prompt_input['input_ids']
        state = DetokenizeState()
        prev_len = 0
        finish_reason = None
        text_cache = ''
        bound_epoch = self.epoch

        async for out in self.instance.async_stream_infer(
                session_id, input_ids, gen_config, mm_data=mm_images or None):
            if self.epoch != bound_epoch:
                # stop_all_sessions() ran after this request bound: drop it
                finish_reason = 'abort'
                await self.stop_session(session_id)
                yield GenOut(response='', history_token_len=0,
                             input_token_len=len(input_ids),
                             generate_token_len=len(out.token_ids),
                             finish_reason=finish_reason, token_ids=[])
                break
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

    # -- logits / ppl / reward scores (reference :314-366) ----------------------------
    async def _score(self, fn, ids: List[int]):
        """``fn(ids, blocks)`` (a ``ModelAgent`` scoring method) on the engine's
        device thread, after the steps queued before it, over scratch blocks that are
        allocated here and freed when it returns."""
        bm = self.engine.scheduler.block_manager
        nblocks = (len(ids) + bm.block_size - 1) // bm.block_size
        if not bm.can_allocate(nblocks):
            raise RuntimeError('not enough free KV blocks for logits request')
        blocks = bm.allocate(nblocks)
        try:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(self.engine._executor, fn, ids, blocks)
        finally:
            bm.free(blocks)

    async def async_get_logits(self, input_ids: List[List[int]]) -> List[np.ndarray]:
        """Full-vocab f32 logits [n, V] per prompt, as numpy (no session state
        kept)."""
        agent = self.engine.model_agent
        return [await self._score(agent.compute_logits, ids) for ids in input_ids]

    async def async_get_reward_score(self, input_ids) -> List[float]:
        """Reward-model scores, one per prompt: the reward head's [n, 1] "logits"
        at the last position."""
        if not getattr(self.engine.model_agent.model, 'is_reward_model', False):
            raise ValueError(f'{self.engine.configs.model.hf_arch} is not a reward model')
        if input_ids and isinstance(input_ids[0], int):
            input_ids = [input_ids]
        logits = await self.async_get_logits(input_ids)
        return [float(x[-1].reshape(-1)[0]) for x in logits]

    async def async_get_ppl(self, input_ids: List[List[int]]) -> List[float]:
        """Per-prompt mean negative log-likelihood of tokens 1..n-1 (0.0 for a
        prompt of fewer than two tokens), each prompt cut at ``max_session_len``.  The
        float64 log-sum-exp runs on the device (``ModelAgent.compute_nll``)."""
        cap = self.engine.configs.scheduler.max_session_len
        input_ids = [ids[:cap] for ids in input_ids]
        agent = self.engine.model_agent
        ppls = []
        for ids in input_ids:
            if len(ids) < 2:
                ppls.append(0.0)
                continue
            ppls.append(float((await self._score(agent.compute_nll, ids)).mean()))
        return ppls

    def close(self):
        self.engine.close()
