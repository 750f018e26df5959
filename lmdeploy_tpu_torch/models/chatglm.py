"""ChatGLM2 / ChatGLM3 / legacy GLM-4 (``ChatGLMModel``,
``ChatGLMForConditionalGeneration``).

Port of ``lmdeploy_tpu/models/chatglm.py``: the GLM-4 compute (``Glm4Model``: partial
interleaved rotary, fused swiglu) without sandwich norms.  The legacy config names are
normalized in ``ModelConfig.from_hf_config``; the weights sit under
``transformer.encoder.layers.N.`` with a fused ``self_attention.query_key_value``
(weight and bias), ``dense`` for the output projection, ``mlp.dense_h_to_4h`` (gate
then up) / ``dense_4h_to_h``, and ``transformer.output_layer`` as the lm_head.
"""
from __future__ import annotations

from typing import Dict

from .glm4 import Glm4Model
from .llama import bias_rows, rows, transposed


class ChatGLMModel(Glm4Model):

    sandwich_norms = False

    def make_assign_plan(self):
        cfg = self.config
        qo, ko, inter = self.q_out, self.kv_out, cfg.intermediate_size
        plan: Dict = {
            'transformer.embedding.word_embeddings.weight': (('embed',), None),
            'transformer.encoder.final_layernorm.weight': (('final_norm',), None)}
        if not cfg.tie_word_embeddings:
            plan['transformer.output_layer.weight'] = (('lm_head',), transposed)
        for layer in range(cfg.num_layers):
            p = f'transformer.encoder.layers.{layer}.'
            plan.update({
                p + 'input_layernorm.weight': (('layers', 'attn_norm', layer), None),
                p + 'post_attention_layernorm.weight': (('layers', 'mlp_norm', layer), None),
                p + 'self_attention.query_key_value.weight': [
                    (('layers', 'wq', layer), rows(0, qo)),
                    (('layers', 'wk', layer), rows(qo, qo + ko)),
                    (('layers', 'wv', layer), rows(qo + ko, qo + 2 * ko))],
                p + 'self_attention.dense.weight': (('layers', 'wo', layer), transposed),
                p + 'mlp.dense_h_to_4h.weight': [
                    (('layers', 'w_gate', layer), rows(0, inter)),
                    (('layers', 'w_up', layer), rows(inter, 2 * inter))],
                p + 'mlp.dense_4h_to_h.weight': (('layers', 'w_down', layer), transposed),
            })
            if cfg.attention_bias:
                plan[p + 'self_attention.query_key_value.bias'] = [
                    (('layers', 'bq', layer), bias_rows(0, qo)),
                    (('layers', 'bk', layer), bias_rows(qo, qo + ko)),
                    (('layers', 'bv', layer), bias_rows(qo + ko, qo + 2 * ko))]
        return plan
