"""Sync Pipeline facade over the async engine.

Port of ``lmdeploy_tpu/pipeline.py`` (private event-loop thread, infer, stream_infer,
chat, get_ppl, get_reward_score).  ``device=None`` serves on the GPU; pass
``device='cpu'`` for the CPU.
"""
from __future__ import annotations

import asyncio
import atexit
import threading
from typing import Dict, Iterator, List, Optional, Union

from .chat_template import ChatTemplateConfig
from .messages import GenerationConfig, Response, TpuEngineConfig
from .serve.async_engine import AsyncEngine, GenOut


class _EventLoopThread:
    """Private asyncio loop on a daemon thread so sync callers can drive async code."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name='lmdeploy-torch-loop')
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def submit(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)


class Pipeline:

    def __init__(self, model_path: str,
                 backend_config: Optional[TpuEngineConfig] = None,
                 chat_template_config: Optional[ChatTemplateConfig] = None,
                 log_level: str = 'WARNING',
                 **kwargs):
        self._loop_thread = _EventLoopThread()
        # Build the engine on the loop thread so all asyncio primitives bind to it.
        fut = self._loop_thread.submit(self._build_async(
            model_path, backend_config, chat_template_config, **kwargs))
        try:
            self.engine: AsyncEngine = fut.result()
        except BaseException:
            self._loop_thread.close()
            raise
        self._closed = False
        atexit.register(self.close)

    async def _build_async(self, model_path, backend_config, chat_template_config,
                           **kwargs):
        return AsyncEngine(model_path, backend_config=backend_config,
                           chat_template_config=chat_template_config, **kwargs)

    # -- public API (reference: pipeline.py:96,144,205) --------------------------------
    def infer(self, prompts, gen_config: Optional[GenerationConfig] = None,
              do_preprocess: bool = True, **kwargs):
        fut = self._loop_thread.submit(self.engine.async_batch_infer(
            prompts, gen_config=gen_config, do_preprocess=do_preprocess, **kwargs))
        return fut.result()

    __call__ = infer

    def stream_infer(self, prompts, gen_config: Optional[GenerationConfig] = None,
                     do_preprocess: bool = True, **kwargs) -> Iterator[GenOut]:
        """Stream GenOut deltas; single prompt only for the sync facade."""
        import queue as _q
        out_q: '_q.Queue' = _q.Queue()
        SENTINEL = object()

        async def run():
            try:
                session_id = self.engine.next_session_id()
                async for item in self.engine.generate(
                        prompts, session_id, gen_config=gen_config,
                        do_preprocess=do_preprocess, **kwargs):
                    out_q.put(item)
            except Exception as e:  # noqa: BLE001
                out_q.put(e)
            finally:
                out_q.put(SENTINEL)

        self._loop_thread.submit(run())
        while True:
            item = out_q.get()
            if item is SENTINEL:
                break
            if isinstance(item, Exception):
                raise item
            yield item

    def chat(self, prompt: str, session=None,
             gen_config: Optional[GenerationConfig] = None, **kwargs):
        """Stateful multi-turn chat; returns the session, whose ``.response``
        holds the latest Response (reference contract: api.py pipeline.chat —
        ``sess = pipe.chat('hi'); sess = pipe.chat('more', session=sess)``)."""
        if session is None:
            session = _ChatSession(self)
        session.chat(prompt, gen_config=gen_config, **kwargs)
        return session

    def get_ppl(self, texts: Union[str, List[str]]):
        """Mean negative log-likelihood per text (reference pipeline.py:105-112)."""
        single = isinstance(texts, str)
        batch = [texts] if single else list(texts)
        ids = [self.engine.tokenizer.encode(t) for t in batch]
        out = self._loop_thread.submit(self.engine.async_get_ppl(ids)).result()
        return out[0] if single else out

    def get_reward_score(self, input_ids):
        """Reward-model scores for one or more tokenized prompts (reference
        pipeline.py:114-119)."""
        return self._loop_thread.submit(
            self.engine.async_get_reward_score(input_ids)).result()

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self.engine.close()
        finally:
            self._loop_thread.close()


class _ChatSession:

    def __init__(self, pipeline: Pipeline):
        self.pipeline = pipeline
        self.messages: List[Dict[str, str]] = []
        self.response: Optional[Response] = None

    def chat(self, prompt: str, gen_config=None, **kwargs) -> Response:
        self.messages.append({'role': 'user', 'content': prompt})
        resp = self.pipeline.infer(self.messages, gen_config=gen_config, **kwargs)
        if isinstance(resp, list):
            resp = resp[0]
        self.messages.append({'role': 'assistant', 'content': resp.text})
        self.response = resp
        return resp
