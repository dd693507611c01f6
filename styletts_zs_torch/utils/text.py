"""Text/phoneme frontend: phoneme-ID vocabulary and tokenization.

A copy of ``styletts_zs_tpu/utils/text.py``: the port keeps its own copy so
that it imports nothing of the JAX package (``tests/test_torch_serve.py``
checks that the two agree).  G2P is out of scope offline: the frontend takes
phoneme strings or ids directly, with a built-in ARPAbet-style inventory and
a letter fallback.
"""
from __future__ import annotations

PAD = "<pad>"
BOS = "<bos>"
EOS = "<eos>"
UNK = "<unk>"
SIL = "<sil>"  # silence / word boundary

# ARPAbet phone inventory (stress-less) + punctuation + letters fallback
_ARPABET = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]
_PUNCT = list(".,!?;:-'\" ")
_LETTERS = [chr(c) for c in range(ord("a"), ord("z") + 1)]

SYMBOLS = [PAD, BOS, EOS, UNK, SIL] + _ARPABET + _PUNCT + _LETTERS
SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
VOCAB_SIZE = len(SYMBOLS)

PAD_ID = SYMBOL_TO_ID[PAD]
BOS_ID = SYMBOL_TO_ID[BOS]
EOS_ID = SYMBOL_TO_ID[EOS]
UNK_ID = SYMBOL_TO_ID[UNK]
SIL_ID = SYMBOL_TO_ID[SIL]


def phonemes_to_ids(phonemes: list[str], *, add_bos_eos: bool = True) -> list[int]:
    """Space-separated ARPAbet phones (or punctuation) -> id list."""
    ids = [SYMBOL_TO_ID.get(p.upper() if p.upper() in SYMBOL_TO_ID else p, UNK_ID)
           for p in phonemes]
    if add_bos_eos:
        ids = [BOS_ID] + ids + [EOS_ID]
    return ids


def text_to_ids(text: str, *, add_bos_eos: bool = True) -> list[int]:
    """Letter-level fallback tokenizer (no G2P offline)."""
    ids = [SYMBOL_TO_ID.get(ch, UNK_ID) for ch in text.lower()]
    if add_bos_eos:
        ids = [BOS_ID] + ids + [EOS_ID]
    return ids


def pad_ids(ids: list[int], length: int) -> list[int]:
    if len(ids) > length:
        return ids[:length]
    return ids + [PAD_ID] * (length - len(ids))
