"""CLIP's byte-level BPE tokenizer, plain Python.

Counterpart of ``lednet_tpu/models/text_encoder/tokenizer.py`` (``_BPE``
:70, ``tokenize`` :142), of which the port keeps its own copy: lower-case
and whitespace clean-up, merges-ranked BPE with ``'</w>'`` word markers,
SOT / EOT wrapping, truncation to the context length (77).

The merges table is the port's own copy of OpenAI CLIP's
``bpe_simple_vocab_16e6.txt.gz`` (sha256
924691ac288e54409236115652ad4aa250f48203de50a9e4722a6ecd48d6804a), at
``data/`` beside this file; ``bpe_path=`` or the ``CLIP_BPE_PATH``
environment variable override it.  Without any merges data ``tokenize``
raises, unless ``allow_hash_fallback=True`` asks for deterministic
per-word hash ids (only sane for randomly initialised text towers).
"""
from __future__ import annotations

import functools
import gzip
import hashlib
import html
import os
import re
import warnings
from typing import List, Optional

import numpy as np

SOT = 49406
EOT = 49407
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77


@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible byte -> unicode mapping (GPT-2/CLIP standard)."""
    bs = (list(range(ord('!'), ord('~') + 1)) +
          list(range(ord('\xa1'), ord('\xac') + 1)) +
          list(range(ord('\xae'), ord('\xff') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r'\s+', ' ', text.strip())
    return text.lower()


_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\s\w]+|\w+", re.IGNORECASE)


class _BPE:
    """Merges-file-backed CLIP BPE."""

    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith('.gz') else open
        with opener(bpe_path, 'rt', encoding='utf-8') as f:
            merges = f.read().split('\n')
        merges = [tuple(m.split()) for m in merges[1:48894 + 1] if m]
        self.byte_enc = _bytes_to_unicode()
        vocab = list(self.byte_enc.values())
        vocab = vocab + [v + '</w>' for v in vocab]
        for merge in merges:
            vocab.append(''.join(merge))
        vocab.extend(['<|startoftext|>', '<|endoftext|>'])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1e9))
            if best not in self.ranks:
                break
            first, second = best
            new = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        out = []
        for word in _WORD_RE.findall(_clean(text)):
            encoded = ''.join(self.byte_enc[b] for b in word.encode('utf-8'))
            out.extend(self.encoder[t] for t in self._bpe(encoded))
        return out


_BUNDLED_BPE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'data', 'bpe_simple_vocab_16e6.txt.gz')

_warned = [False]


def _hash_encode(text: str) -> List[int]:
    """Deterministic per-word fallback ids in [1000, SOT)."""
    out = []
    for word in _WORD_RE.findall(_clean(text)):
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        out.append(1000 + h % (SOT - 1000))
    return out


@functools.lru_cache()
def _get_bpe(bpe_path: Optional[str]):
    if bpe_path and os.path.exists(bpe_path):
        return _BPE(bpe_path)
    return None


def tokenize(texts, context_length: int = CONTEXT_LENGTH,
             bpe_path: Optional[str] = None,
             allow_hash_fallback: bool = False) -> np.ndarray:
    """Texts -> (N, context_length) int32 token ids, SOT/EOT wrapped and
    truncated like the reference tokenizer.

    Ids match OpenAI CLIP exactly via the bundled merges table; without any
    merges data this raises, unless ``allow_hash_fallback=True`` opts into
    the deterministic (CLIP-incompatible) per-word hash ids.
    """
    if isinstance(texts, str):
        texts = [texts]
    bpe = _get_bpe(bpe_path or os.environ.get('CLIP_BPE_PATH')
                   or _BUNDLED_BPE)
    if bpe is None:
        if not allow_hash_fallback:
            raise FileNotFoundError(
                'CLIP BPE merges data not found (bundled file missing and '
                'no bpe_path/CLIP_BPE_PATH override). Pass '
                'allow_hash_fallback=True only for randomly initialized '
                'text towers.')
        if not _warned[0]:
            warnings.warn('CLIP BPE merges file not found; using the hash '
                          'fallback tokenizer (set CLIP_BPE_PATH for real '
                          'CLIP-compatible ids)', stacklevel=2)
            _warned[0] = True
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = bpe.encode(text) if bpe else _hash_encode(text)
        ids = [SOT] + ids[:context_length - 2] + [EOT]
        out[i, :len(ids)] = ids
    return out
