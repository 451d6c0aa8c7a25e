"""Tokenizers for the port's server (port of ``llm_d_tpu.utils.tokenizer``).

``ByteTokenizer`` needs nothing; ``HFTokenizer`` imports ``transformers``
only when it is asked for, and raises where that package is missing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class ByteTokenizer:
    """Deterministic, dependency-free tokenizer: UTF-8 bytes + specials.

    Vocabulary: 256 byte tokens, then BOS/EOS/PAD."""

    def __init__(self) -> None:
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Thin wrapper over ``transformers.AutoTokenizer``."""

    def __init__(self, name_or_path: str) -> None:
        from transformers import AutoTokenizer  # lazy: heavy import

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def get_tokenizer(name_or_path: Optional[str]):
    """``None``/"byte" -> ByteTokenizer, else HF."""
    if name_or_path in (None, "", "byte"):
        return ByteTokenizer()
    return HFTokenizer(name_or_path)
