"""OpenAI wire-format schemas (pydantic).

Port of ``lmdeploy_tpu/serve/openai_protocol.py``: a host module, copied as it is.

Reference analog: ``lmdeploy/serve/openai/protocol.py`` (ChatCompletionRequest etc.).
Only the fields the engine honors are modeled; unknown fields are accepted and ignored
so standard OpenAI clients work unmodified.
"""
from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Union

from pydantic import BaseModel, ConfigDict, Field


def _id(prefix: str) -> str:
    return f'{prefix}-{uuid.uuid4().hex}'


class ModelCard(BaseModel):
    id: str
    object: str = 'model'
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = 'lmdeploy-tpu'


class ModelList(BaseModel):
    object: str = 'list'
    data: List[ModelCard] = []


class UsageInfo(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class ChatCompletionRequest(BaseModel):
    model_config = ConfigDict(extra='allow')

    model: str
    messages: Union[str, List[Dict[str, Any]]]
    temperature: Optional[float] = 0.7
    top_p: Optional[float] = 1.0
    top_k: Optional[int] = 40
    min_p: Optional[float] = 0.0
    n: Optional[int] = 1
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: Optional[bool] = False
    stream_options: Optional[Dict[str, Any]] = None
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    repetition_penalty: Optional[float] = 1.0
    logprobs: Optional[bool] = False
    top_logprobs: Optional[int] = None
    seed: Optional[int] = None
    user: Optional[str] = None
    skip_special_tokens: Optional[bool] = True
    response_format: Optional[Dict[str, Any]] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Any] = None


class ChatMessage(BaseModel):
    role: str
    content: Optional[str] = None
    reasoning_content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None


class ChatCompletionChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class ChatCompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: _id('chatcmpl'))
    object: str = 'chat.completion'
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ''
    choices: List[ChatCompletionChoice] = []
    usage: UsageInfo = UsageInfo()


class DeltaMessage(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None
    reasoning_content: Optional[str] = None
    # incremental tool-call frames: [{'index', 'id'?, 'type'?, 'function':
    # {'name'?, 'arguments'?}}] (OpenAI streaming wire format)
    tool_calls: Optional[List[Dict[str, Any]]] = None


class ChatCompletionStreamChoice(BaseModel):
    index: int = 0
    delta: DeltaMessage = DeltaMessage()
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class ChatCompletionStreamResponse(BaseModel):
    id: str = Field(default_factory=lambda: _id('chatcmpl'))
    object: str = 'chat.completion.chunk'
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ''
    choices: List[ChatCompletionStreamChoice] = []
    usage: Optional[UsageInfo] = None


class CompletionRequest(BaseModel):
    model_config = ConfigDict(extra='allow')

    model: str
    prompt: Union[str, List[str]]
    suffix: Optional[str] = None
    temperature: Optional[float] = 0.7
    top_p: Optional[float] = 1.0
    top_k: Optional[int] = 40
    n: Optional[int] = 1
    max_tokens: Optional[int] = 16
    stop: Optional[Union[str, List[str]]] = None
    stream: Optional[bool] = False
    presence_penalty: Optional[float] = 0.0
    frequency_penalty: Optional[float] = 0.0
    repetition_penalty: Optional[float] = 1.0
    logprobs: Optional[int] = None
    seed: Optional[int] = None
    user: Optional[str] = None


class CompletionChoice(BaseModel):
    index: int = 0
    text: str = ''
    finish_reason: Optional[str] = None
    logprobs: Optional[Any] = None


class CompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: _id('cmpl'))
    object: str = 'text_completion'
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ''
    choices: List[CompletionChoice] = []
    usage: UsageInfo = UsageInfo()


class ErrorResponse(BaseModel):
    message: str
    type: str = 'invalid_request_error'
    code: Optional[int] = None


class GenerateRequest(BaseModel):
    """Token-level API for RL rollout / benchmarking (reference: endpoints/generate.py)."""

    model_config = ConfigDict(extra='allow')

    input_ids: Optional[List[int]] = None
    prompt: Optional[str] = None
    session_id: Optional[int] = None
    max_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    do_sample: bool = False
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    stream: bool = False
