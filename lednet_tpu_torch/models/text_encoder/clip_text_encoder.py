"""CLIP's text tower: the class embeddings of an open vocabulary (SAN).

Counterpart of ``lednet_tpu/models/text_encoder/clip_text_encoder.py``
(``PREDEFINED_TEMPLATES`` and ``get_predefined_templates`` :27-49,
``_TextBlock`` :51, ``CLIPTextEncoder`` :76):

- every template filled with every class name is tokenised once, at
  construction, into the non-persistent buffers ``tokens`` (T x C, 77)
  and ``eot`` (the index of each prompt's end token, the argmax of its
  ids), so that the forward does no host work and a CUDA graph can
  capture it;
- the forward: ``token_embedding`` (49,408 ids) plus the learned
  ``positional_embedding`` (context 77); ``num_layers`` pre-LN blocks
  ``block{i}`` (``ln_1``, ``q`` / ``k`` / ``v`` with the causal ``-inf``
  mask above the diagonal, ``proj``, ``ln_2``, ``fc1``, exact GELU,
  ``fc2``); ``ln_final``; the features at the end token through
  ``text_projection`` (no bias), L2-normalised; the mean over the
  templates, normalised again; with ``cat_bg`` the normalised
  ``bg_embed`` appended.  Every LayerNorm is flax's (eps 1e-6).

The JAX package recomputes these embeddings at every call, and so does the
port: they are a function of the weights, which training updates.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lednet_tpu_torch.models.backbones.mit import LN_EPS
from lednet_tpu_torch.models.layers import attention, merge_heads, split_heads
from lednet_tpu_torch.models.text_encoder.tokenizer import VOCAB_SIZE, tokenize
from lednet_tpu_torch.registry import MODELS

PREDEFINED_TEMPLATES = {
    'vild': [
        'a photo of a {}.', 'a photo of the {}.', 'a photo of one {}.',
        'a photo of many {}.', 'a photo of a small {}.',
        'a photo of a large {}.', 'a photo of the small {}.',
        'a photo of the large {}.', 'a cropped photo of a {}.',
        'a close-up photo of a {}.', 'a bright photo of a {}.',
        'a dark photo of a {}.', 'a photo of a clean {}.',
        'a photo of a dirty {}.', 'there is a {} in the scene.',
        'there is the {} in the scene.', 'this is a {} in the scene.',
        'this is the {} in the scene.', 'this is one {} in the scene.',
    ],
    'simple': ['a photo of a {}.'],
}


def get_predefined_templates(name: str) -> List[str]:
    if name not in PREDEFINED_TEMPLATES:
        raise ValueError(f'Template set {name} not found '
                         f'(have {sorted(PREDEFINED_TEMPLATES)})')
    return PREDEFINED_TEMPLATES[name]


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / (|x| + 1e-12)`` over the last axis."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class _TextBlock(nn.Module):
    """A pre-LN block with separate ``q`` / ``k`` / ``v`` (also SAN's
    side-adapter block, ``_SANBlock``)."""

    def __init__(self, dims: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.ln_1 = nn.LayerNorm(dims, eps=LN_EPS)
        self.q = nn.Linear(dims, dims)
        self.k = nn.Linear(dims, dims)
        self.v = nn.Linear(dims, dims)
        self.proj = nn.Linear(dims, dims)
        self.ln_2 = nn.LayerNorm(dims, eps=LN_EPS)
        self.fc1 = nn.Linear(dims, mlp_ratio * dims)
        self.fc2 = nn.Linear(mlp_ratio * dims, dims)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.ln_1(x)
        q, k, v = (split_heads(f(h), self.num_heads)
                   for f in (self.q, self.k, self.v))
        x = x + self.proj(merge_heads(attention(q, k, v, mask)))
        return x + self.fc2(F.gelu(self.fc1(self.ln_2(x))))


@MODELS.register_module()
class CLIPTextEncoder(nn.Module):
    """``forward()`` takes no input and returns the (num_classes [+ 1],
    output_dims) normalised class embeddings."""

    def __init__(self, vocabulary: Optional[Sequence[str]] = None,
                 templates='vild', total_vocab_size: int = VOCAB_SIZE,
                 context_length: int = 77, embed_dims: int = 512,
                 num_layers: int = 12, num_heads: int = 8,
                 output_dims: int = 512, cat_bg: bool = True,
                 bpe_path: Optional[str] = None):
        super().__init__()
        if not vocabulary:
            raise ValueError('CLIPTextEncoder requires a vocabulary')
        names = get_predefined_templates(templates) \
            if isinstance(templates, str) else list(templates)
        tokens = np.stack([tokenize([t.format(noun) for noun in vocabulary],
                                    context_length, bpe_path)
                           for t in names])                 # (T, C, L)
        self.num_templates, self.num_classes = tokens.shape[:2]
        self.output_dims = output_dims
        tokens = torch.from_numpy(tokens.reshape(-1, context_length).astype(np.int64))
        self.register_buffer('tokens', tokens, persistent=False)
        self.register_buffer('eot', tokens.argmax(-1), persistent=False)
        self.register_buffer('causal', torch.full(
            (context_length, context_length), float('-inf')).triu(1),
            persistent=False)
        self.token_embedding = nn.Embedding(total_vocab_size, embed_dims)
        self.token_embedding.raw_init = {'weight': ('normal', embed_dims ** -0.5)}
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, embed_dims))
        self.text_projection = nn.Parameter(torch.zeros(embed_dims, output_dims))
        self.raw_init = {'positional_embedding': ('normal', 0.01),
                         'text_projection': ('normal', embed_dims ** -0.5)}
        for i in range(num_layers):
            self.add_module(f'block{i}', _TextBlock(embed_dims, num_heads))
        self.num_layers = num_layers
        self.ln_final = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.cat_bg = cat_bg
        if cat_bg:
            self.bg_embed = nn.Parameter(torch.zeros(1, output_dims))
            self.raw_init['bg_embed'] = ('normal', output_dims ** -0.5)

    def encode(self) -> torch.Tensor:
        """(T x C, output_dims) normalised embeddings of every prompt."""
        x = self.token_embedding(self.tokens) + self.positional_embedding
        for i in range(self.num_layers):
            x = getattr(self, f'block{i}')(x, self.causal)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), self.eot]
        return l2_normalize(x @ self.text_projection)

    def forward(self) -> torch.Tensor:
        embeds = self.encode().view(self.num_templates, self.num_classes,
                                    self.output_dims).mean(0)
        embeds = l2_normalize(embeds)
        if self.cat_bg:
            embeds = torch.cat([embeds, l2_normalize(self.bg_embed)], 0)
        return embeds
