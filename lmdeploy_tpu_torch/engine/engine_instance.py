"""Per-session client handle over the engine.

Copy of ``lmdeploy_tpu/engine/engine_instance.py`` for the PyTorch port.
"""
from __future__ import annotations

from typing import AsyncIterator, List, Optional

from ..messages import EngineOutput, GenerationConfig, ResponseType
from ..paging.seq import SamplingParams


class EngineInstance:

    def __init__(self, engine):
        self.engine = engine

    async def async_stream_infer(self, session_id: int, input_ids: List[int],
                                 gen_config: Optional[GenerationConfig] = None,
                                 mm_data: Optional[List] = None,
                                 **kwargs) -> AsyncIterator[EngineOutput]:
        """Stream EngineOutput events for one generation request."""
        gen_config = gen_config or GenerationConfig()
        gen_config.validate()
        sampling = SamplingParams.from_gen_config(
            gen_config, self.engine.model_config.eos_token_id)
        queue = self.engine.add_message(session_id, list(input_ids), sampling,
                                        mm_data=mm_data)
        while True:
            out: EngineOutput = await queue.get()
            yield out
            if out.status != ResponseType.SUCCESS:
                break

    async def async_infer(self, session_id: int, input_ids: List[int],
                          gen_config: Optional[GenerationConfig] = None,
                          **kwargs) -> EngineOutput:
        last = None
        async for out in self.async_stream_infer(session_id, input_ids, gen_config,
                                                 **kwargs):
            last = out
        return last

    async def async_end(self, session_id: int):
        self.engine.end_session(session_id)

    async def async_cancel(self, session_id: int):
        session = self.engine.scheduler.seq_manager.get_session(session_id)
        if session:
            for seq_id in list(session.sequences):
                await self.engine.stop_request(seq_id)

    def close(self):
        pass
