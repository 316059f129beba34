"""CLIP byte-pair-encoding tokenizer (the port's copy of
``text2nerf_tpu/models/tokenizer.py``).

Loads the ``vocab.json`` + ``merges.txt`` that ship with the pretrained
text towers (the diffusers ``tokenizer/`` subfolder, or an HF CLIP
directory), so prompts map to the ids those towers were trained on.
Matches ``transformers.CLIPTokenizer`` without ftfy: whitespace cleanup
and lowercasing.  Pure Python; the ``regex`` module (Unicode letter
classes) is imported when a tokenizer is built.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→unicode map: printable bytes map to
    themselves, the rest to points above 255."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


class CLIPBPETokenizer:
    """BPE tokenizer over a CLIP vocabulary.

    Parameters mirror the HF artifacts: ``vocab`` maps token string → id,
    ``merges`` is the ranked merge list.  ``pad_token`` defaults to the
    end-of-text token (original CLIP); SD2 checkpoints ship "!" instead —
    pass whatever the checkpoint's tokenizer_config declares.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        pad_token: Optional[str] = None,
    ):
        import regex

        self.encoder = vocab
        self.byte_encoder = bytes_to_unicode()
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_id = vocab[bos_token]
        self.eos_id = vocab[eos_token]
        self.pad_id = vocab[pad_token] if pad_token else self.eos_id
        # literal special tokens in a prompt map to their single ids, not
        # byte-BPE pieces (HF's CLIPTokenizer seeds its cache the same way;
        # the byte encoder maps printable ASCII to itself)
        self._cache = {bos_token: bos_token, eos_token: eos_token}
        self._pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_dir(path: str) -> Optional["CLIPBPETokenizer"]:
        """Load from a directory with vocab.json + merges.txt (the
        ``tokenizer/`` subfolder of a diffusers checkpoint, or an HF CLIP
        checkpoint dir).  Returns None when the files are absent."""
        vocab_file = os.path.join(path, "vocab.json")
        merges_file = os.path.join(path, "merges.txt")
        if not (os.path.isfile(vocab_file) and os.path.isfile(merges_file)):
            return None
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines[1:]:  # first line is the version header
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        pad_token = None
        cfg_file = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cfg_file):
            with open(cfg_file, encoding="utf-8") as f:
                cfg = json.load(f)
            pad = cfg.get("pad_token")
            if isinstance(pad, dict):  # AddedToken serialization
                pad = pad.get("content")
            if isinstance(pad, str) and pad in vocab:
                pad_token = pad
        return CLIPBPETokenizer(vocab, merges, pad_token=pad_token)

    # -- BPE ------------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no special tokens)."""
        import re

        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(
                self.encoder[piece] for piece in self._bpe(token).split(" ")
            )
        return ids

    def __call__(self, texts: List[str], context_length: int = 77):
        """Batch encode with BOS/EOS, truncation, and padding — the
        CLIPTokenizer(padding='max_length', truncation=True) behavior the
        SD pipelines rely on.  Returns (B, context_length) int32."""
        import numpy as np

        out = np.full((len(texts), context_length), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + self.encode(text)[: context_length - 2]
            ids.append(self.eos_id)
            out[i, : len(ids)] = ids
        return out
