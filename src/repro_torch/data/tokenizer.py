"""Byte-level tokenizer (offline container: no external vocabs).

256 byte tokens + 3 specials.  Deterministic, reversible, and adequate for
the ~100M-parameter end-to-end training example; production swaps in a
learned BPE via the same interface.  A copy of ``repro.data.tokenizer``.
"""
from __future__ import annotations

from typing import Iterable, List

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


class ByteTokenizer:
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID
    vocab_size = VOCAB_SIZE

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")
