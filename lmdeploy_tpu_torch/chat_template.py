"""Chat-template registry.

Reference analog: ``lmdeploy/model.py`` (MODELS registry, get_chat_template, ~40 templates).
We keep a compact native registry for the common families and fall back to the HF
tokenizer's bundled jinja template (``apply_chat_template``), which covers the long tail
without maintaining 40 hand-written templates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

MODELS: Dict[str, type] = {}


def register_template(name):
    def wrap(cls):
        MODELS[name] = cls
        cls.name = name
        return cls
    return wrap


@dataclass
class ChatTemplateConfig:
    """User override for the chat template (reference: lmdeploy/model.py ChatTemplateConfig)."""

    model_name: Optional[str] = None
    system: Optional[str] = None
    meta_instruction: Optional[str] = None
    user: Optional[str] = None
    assistant: Optional[str] = None
    eosys: Optional[str] = None
    eoh: Optional[str] = None
    eoa: Optional[str] = None
    separator: Optional[str] = None
    stop_words: Optional[List[str]] = None
    capability: Optional[str] = None

    def chat_template(self, tokenizer=None):
        if self.model_name == 'hf':
            # explicit HF-jinja delegation (reference: model.py:758)
            tmpl = HFChatTemplate(tokenizer)
        elif self.model_name:
            if self.model_name not in MODELS:
                raise ValueError(f'unknown chat template {self.model_name!r}; '
                                 f'available: {sorted(MODELS)}')
            tmpl = MODELS[self.model_name]()
        else:
            tmpl = HFChatTemplate(tokenizer) if tokenizer is not None else BaseChatTemplate()
        for attr in ('system', 'meta_instruction', 'user', 'assistant', 'eosys', 'eoh',
                     'eoa', 'separator', 'stop_words'):
            v = getattr(self, attr)
            if v is not None and hasattr(tmpl, attr):
                setattr(tmpl, attr, v)
        return tmpl


@register_template('base')
class BaseChatTemplate:
    """Raw completion: no wrapping."""

    system = ''
    meta_instruction = None
    user = ''
    eoh = ''
    assistant = ''
    eoa = ''
    eosys = ''
    separator = ''
    stop_words: Optional[List[str]] = None

    def get_prompt(self, prompt: str, sequence_start: bool = True) -> str:
        return prompt

    def messages2prompt(self, messages, sequence_start: bool = True, **kwargs) -> str:
        if isinstance(messages, str):
            return self.get_prompt(messages, sequence_start)
        ret = ''
        if self.meta_instruction and sequence_start and \
                not any(m['role'] == 'system' for m in messages):
            ret += f'{self.system}{self.meta_instruction}{self.eosys}'
        box = {'system': self.system, 'user': self.user, 'assistant': self.assistant}
        eox = {'system': self.eosys, 'user': self.eoh, 'assistant': self.eoa}
        for msg in messages:
            role, content = msg['role'], _flatten_content(msg.get('content') or '')
            ret += f'{box.get(role, "")}{content}{eox.get(role, "")}'
        ret += self.assistant
        return ret


def _flatten_content(content) -> str:
    if isinstance(content, str):
        return content
    # OpenAI-style list of content parts
    parts = []
    for item in content:
        if isinstance(item, dict) and item.get('type') == 'text':
            parts.append(item.get('text', ''))
    return ''.join(parts)


@register_template('llama2')
class Llama2(BaseChatTemplate):
    system = '[INST] <<SYS>>\n'
    meta_instruction = ('You are a helpful, respectful and honest assistant.')
    eosys = '\n<</SYS>>\n\n'
    user = '[INST] '
    eoh = ' [/INST] '
    assistant = ''
    eoa = '</s>'
    separator = ''

    def messages2prompt(self, messages, sequence_start=True, **kwargs):
        if isinstance(messages, str):
            return f'{self.user}{messages}{self.eoh}'
        ret = ''
        sys_text = ''
        for msg in messages:
            role, content = msg['role'], _flatten_content(msg.get('content') or '')
            if role == 'system':
                sys_text = f'<<SYS>>\n{content}\n<</SYS>>\n\n'
            elif role == 'user':
                ret += f'[INST] {sys_text}{content} [/INST] '
                sys_text = ''
            elif role == 'assistant':
                ret += f'{content}</s>'
        return ret


@register_template('llama3')
class Llama3(BaseChatTemplate):
    system = '<|start_header_id|>system<|end_header_id|>\n\n'
    meta_instruction = None
    eosys = '<|eot_id|>'
    user = '<|start_header_id|>user<|end_header_id|>\n\n'
    eoh = '<|eot_id|>'
    assistant = '<|start_header_id|>assistant<|end_header_id|>\n\n'
    eoa = '<|eot_id|>'
    separator = ''
    stop_words = ['<|eot_id|>', '<|end_of_text|>']

    def messages2prompt(self, messages, sequence_start=True, **kwargs):
        prefix = '<|begin_of_text|>' if sequence_start else ''
        return prefix + super().messages2prompt(messages, sequence_start, **kwargs)

    def get_prompt(self, prompt, sequence_start=True):
        prefix = '<|begin_of_text|>' if sequence_start else ''
        return (f'{prefix}{self.user}{prompt}{self.eoh}{self.assistant}')


@register_template('chatml')
@register_template('qwen')
class ChatML(BaseChatTemplate):
    """ChatML (qwen/internlm-xcomposer style)."""

    system = '<|im_start|>system\n'
    meta_instruction = 'You are a helpful assistant.'
    eosys = '<|im_end|>\n'
    user = '<|im_start|>user\n'
    eoh = '<|im_end|>\n'
    assistant = '<|im_start|>assistant\n'
    eoa = '<|im_end|>'
    separator = '\n'
    stop_words = ['<|im_end|>']

    def get_prompt(self, prompt, sequence_start=True):
        ret = ''
        if sequence_start and self.meta_instruction:
            ret += f'{self.system}{self.meta_instruction}{self.eosys}'
        return f'{ret}{self.user}{prompt}{self.eoh}{self.assistant}'


@register_template('internlm2')
class InternLM2(ChatML):
    meta_instruction = ('You are an AI assistant whose name is InternLM (书生·浦语).')
    stop_words = ['<|im_end|>', '<|action_end|>']


@register_template('mistral')
@register_template('mixtral')
class Mistral(BaseChatTemplate):
    """Mistral-instruct [INST] format (no system segment)."""

    user = '[INST] '
    eoh = ' [/INST]'
    assistant = ''
    eoa = '</s>'

    def get_prompt(self, prompt, sequence_start=True):
        return f'<s>[INST] {prompt} [/INST]' if sequence_start \
            else f'[INST] {prompt} [/INST]'


@register_template('deepseek')
class DeepSeek(BaseChatTemplate):
    system = ''
    meta_instruction = None
    user = 'User: '
    eoh = '\n\n'
    assistant = 'Assistant: '
    eoa = '<｜end▁of▁sentence｜>'
    stop_words = ['<｜end▁of▁sentence｜>']


@register_template('deepseek-r1')
class DeepSeekR1(BaseChatTemplate):
    user = '<｜User｜>'
    eoh = ''
    assistant = '<｜Assistant｜>'
    eoa = '<｜end▁of▁sentence｜>'
    stop_words = ['<｜end▁of▁sentence｜>']


@register_template('deepseek-vl2')
class DeepSeekVL2(BaseChatTemplate):
    """DeepSeek-VL2 (reference: model.py DeepSeekVL2 ':545')."""
    system = ''
    meta_instruction = None
    user = '<|User|>: '
    eoh = '\n\n'
    assistant = '<|Assistant|>: '
    eoa = '<｜end▁of▁sentence｜>'
    stop_words = ['<｜end▁of▁sentence｜>']


class _DeepSeekV3Family(BaseChatTemplate):
    """DeepSeek V3.x wire format (reference: deepseek_v32_encoding.py):
    bos + system content rendered bare, '<｜User｜>{content}<｜Assistant｜>'
    turns, assistant turns closed by eos; the LAST user turn opens a
    '<think>' span in thinking mode and '</think>' otherwise."""
    bos = '<｜begin▁of▁sentence｜>'
    user = '<｜User｜>'
    assistant = '<｜Assistant｜>'
    eoa = '<｜end▁of▁sentence｜>'
    stop_words = ['<｜end▁of▁sentence｜>']
    thinking = False

    def messages2prompt(self, messages, sequence_start=True, **kwargs):
        if isinstance(messages, str):
            messages = [{'role': 'user', 'content': messages}]
        thinking = bool(kwargs.get('enable_thinking',
                                   kwargs.get('thinking', self.thinking)))
        out = self.bos if sequence_start else ''
        last_user = max((i for i, m in enumerate(messages)
                         if m.get('role') in ('user', 'developer')), default=-1)
        for i, m in enumerate(messages):
            role = m.get('role')
            content = m.get('content') or ''
            if role == 'system':
                out += content
            elif role in ('user', 'developer', 'tool'):
                out += f'{self.user}{content}{self.assistant}'
                out += '<think>' if (thinking and i == last_user) \
                    else '</think>'
            elif role == 'assistant':
                out += f'{content}{self.eoa}'
        return out

    def get_prompt(self, prompt, sequence_start=True):
        return self.messages2prompt([{'role': 'user', 'content': prompt}],
                                    sequence_start)


@register_template('deepseek-v32')
@register_template('deepseek-v3.2')
class DeepSeekV32(_DeepSeekV3Family):
    """DeepSeek-V3.2 (reference: model.py ':669' +
    deepseek_v32_encoding.py render_message)."""


@register_template('deepseek-v4')
class DeepSeekV4(_DeepSeekV3Family):
    """DeepSeek-V4 (reference: model.py ':587' + deepseek_v4_encoding.py;
    same turn framing as V3.2 — reasoning_effort/tool blocks ride the system
    message upstream)."""


@register_template('vicuna')
class Vicuna(BaseChatTemplate):
    system = ''
    meta_instruction = ('A chat between a curious user and an artificial '
                        'intelligence assistant. The assistant gives helpful, '
                        'detailed, and polite answers to the user\'s questions. ')
    eosys = ''
    user = 'USER: '
    eoh = ' '
    assistant = 'ASSISTANT: '
    eoa = '</s>'


@register_template('baichuan2')
class Baichuan2(BaseChatTemplate):
    user = '<reserved_106>'
    eoh = ''
    assistant = '<reserved_107>'
    eoa = ''


@register_template('phi-3')
class Phi3(BaseChatTemplate):
    system = '<|system|>\n'
    eosys = '<|end|>\n'
    user = '<|user|>\n'
    eoh = '<|end|>\n'
    assistant = '<|assistant|>\n'
    eoa = '<|end|>\n'
    stop_words = ['<|end|>']


@register_template('gemma')
class Gemma(BaseChatTemplate):
    system = '<start_of_turn>user\n'
    user = '<start_of_turn>user\n'
    eoh = '<end_of_turn>\n'
    assistant = '<start_of_turn>model\n'
    eoa = '<end_of_turn>\n'
    stop_words = ['<end_of_turn>']


class HFChatTemplate(BaseChatTemplate):
    """Fallback: delegate to the HF tokenizer's jinja chat template."""

    name = 'hf'

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer
        self.stop_words = None

    def get_prompt(self, prompt: str, sequence_start: bool = True) -> str:
        return self.messages2prompt([{'role': 'user', 'content': prompt}], sequence_start)

    def messages2prompt(self, messages, sequence_start=True, **kwargs) -> str:
        if isinstance(messages, str):
            messages = [{'role': 'user', 'content': messages}]
        model = getattr(self._tokenizer, 'model', self._tokenizer)
        try:
            return model.apply_chat_template(messages, tokenize=False,
                                             add_generation_prompt=True)
        except Exception:
            return BaseChatTemplate.messages2prompt(self, messages, sequence_start)


@register_template('llava-v1')
class LlavaV1(Vicuna):
    """llava-1.5 (vicuna wrapper; ``<image>`` markers stay inline).

    Reference: model.py llava-v1 (``:286``)."""
    meta_instruction = ("A chat between a curious human and an artificial "
                        "intelligence assistant. The assistant gives helpful, "
                        "detailed, and polite answers to the human's questions.")


@register_template('llava-chatml')
class LlavaChatML(ChatML):
    """Reference: model.py llava-chatml (``:723``)."""
    meta_instruction = 'Answer the questions.'


@register_template('codellama')
class CodeLlama(Llama2):
    """Reference: model.py codellama (``:348``) — llama2 wrapping, no default
    system prompt (completion/infilling callers set their own)."""
    meta_instruction = None


@register_template('chatglm')
class ChatGLM(BaseChatTemplate):
    """Reference: model.py chatglm (``:393``)."""
    user = '<|user|>\n'
    eoh = ''
    assistant = '<|assistant|>\n'
    eoa = ''
    system = '<|system|>\n'
    eosys = ''


@register_template('cogvlm')
class CogVLM(BaseChatTemplate):
    """Reference: model.py cogvlm (``:200``)."""
    user = 'Question: '
    eoh = ' '
    assistant = 'Answer:'
    eoa = '</s>'


@register_template('internvl-zh')
class InternVLZh(BaseChatTemplate):
    """Reference: model.py internvl-zh (``:469``)."""
    user = '<human>: '
    eoh = ' '
    assistant = '<bot>: '
    eoa = '</s>'


@register_template('deepseek-vl')
class DeepSeekVL(BaseChatTemplate):
    """Reference: model.py deepseek-vl (``:500``)."""
    meta_instruction = ('You are a helpful language and vision assistant. '
                        'You are able to understand the visual content that '
                        'the user provides, and assist the user with a '
                        'variety of tasks using natural language.')
    eosys = '\n\n'
    user = 'User: '
    eoh = '\n\n'
    assistant = 'Assistant: '
    eoa = '<\uff5cend\u2581of\u2581sentence\uff5c>'


_NAME_HINTS = [
    ('llama-2', 'llama2'), ('llama2', 'llama2'),
    ('llama-3', 'llama3'), ('llama3', 'llama3'),
    ('qwen', 'qwen'),
    ('internlm2', 'internlm2'), ('internlm3', 'internlm2'),
    ('gemma', 'gemma'),
    ('tinyllama', 'chatml'),
    ('deepseek-r1', 'deepseek-r1'), ('deepseek-vl', 'deepseek-vl'),
    ('deepseek', 'deepseek'),
    ('mistral', 'mistral'), ('mixtral', 'mistral'),
    ('vicuna', 'vicuna'), ('baichuan2', 'baichuan2'), ('phi-3', 'phi-3'),
    ('llava-v1.5', 'llava-v1'), ('llava', 'llava-v1'),
    ('codellama', 'codellama'), ('code-llama', 'codellama'),
    ('chatglm', 'chatglm'), ('glm-4', 'chatglm'),
    ('cogvlm', 'cogvlm'), ('internvl', 'internvl-zh'),
]


def best_match_model(model_path: str) -> Optional[str]:
    """Heuristic template match from the model path (reference: model.py best_match_model)."""
    name = model_path.lower().rstrip('/').split('/')[-1]
    for hint, tmpl in _NAME_HINTS:
        if hint in name:
            return tmpl
    return None


def get_chat_template(model_path: str, chat_template_config: Optional[ChatTemplateConfig] = None,
                      tokenizer=None):
    if chat_template_config is not None:
        return chat_template_config.chat_template(tokenizer)
    # Prefer the HF-bundled template when present; fall back to heuristics.
    model = getattr(tokenizer, 'model', tokenizer) if tokenizer is not None else None
    if model is not None and getattr(model, 'chat_template', None):
        return HFChatTemplate(tokenizer)
    matched = best_match_model(model_path)
    if matched:
        return MODELS[matched]()
    if model is not None:
        return HFChatTemplate(tokenizer)
    return BaseChatTemplate()
