"""CLIP's byte-level BPE tokenizer for clip_loc's text embeddings
(counterpart of `instance_based_loc_tpu/models/bpe.py`; reference
`clip_loc/clip_utils.py:30-54`).

The openai `SimpleTokenizer` algorithm: text cleanup as HF CLIPTokenizer's
no-ftfy path, pre-tokenization, the byte -> unicode alphabet, and greedy
byte-pair merges by rank with the `</w>` end-of-word marker, read from a
CLIP `vocab.json` and `merges.txt`.

The JAX package pre-tokenizes with the third-party `regex` module's pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+          (IGNORECASE)

and stdlib `re` has no `\\p{L}` / `\\p{N}` classes (`[^\\W\\d_]` would also
take numbers such as "²" and "½" for letters). `pre_tokenize` scans the
text with the same alternatives in the same order, classifying each
character by its Unicode general category (`unicodedata`), so it takes the
same tokens with the standard library alone.
"""

from __future__ import annotations

import functools
import json
import unicodedata

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _category(ch: str) -> str:
    """"L" for a letter, "N" for a number, " " for white space, else "P"
    (Unicode general categories L* and N*, as `\\p{L}` and `\\p{N}`)."""
    major = unicodedata.category(ch)[0]
    if major in "LN":
        return major
    return " " if ch.isspace() else "P"


def pre_tokenize(text: str) -> list[str]:
    """`regex.findall` of the JAX package's pattern, without `regex`: at each
    position the first alternative that matches is taken (special tokens,
    contractions, a run of letters, one number, a run of other
    non-space characters); white space is skipped."""
    out = []
    i, n = 0, len(text)
    while i < n:
        low = text[i:i + 15].lower()
        lit = next((t for t in _SPECIAL + _CONTRACTIONS if low.startswith(t)),
                   None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _category(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind == "L":
            while j < n and _category(text[j]) == "L":
                j += 1
        elif kind == "P":
            while j < n and _category(text[j]) == "P":
                j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _basic_clean(text: str) -> str:
    """HF CLIPTokenizer's no-ftfy path: BasicTokenizer(strip_accents=False,
    do_split_on_punc=False), then space-joined lowercased words."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        out.append(" " if unicodedata.category(ch) == "Zs"
                   or ch in ("\t", "\n", "\r") else ch)
    text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in "".join(out))
    return " ".join(tok.lower() for tok in text.split())


class ClipBPETokenizer:
    def __init__(self, vocab_path: str, merges_path: str,
                 context_length: int = 77):
        with open(vocab_path, encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {}
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>" if len(token) > 1 else word[0]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if first not in word[i:]:
                    new_word.extend(word[i:])
                    break
                j = word.index(first, i)
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        tokens = []
        for tok in pre_tokenize(_basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.bpe(tok).split(" "))
        return tokens

    def encode(self, text: str, pad: bool = True) -> list[int]:
        """[SOT] bpe ids [EOT], truncated to `context_length` (the last id
        stays EOT) and zero-padded to it (openai `clip.tokenize`)."""
        unk = self.eot
        ids = [self.sot] + [self.encoder.get(t, unk)
                            for t in self.tokenize(text)] + [self.eot]
        ids = ids[:self.context_length]
        ids[-1] = self.eot
        if pad:
            ids = ids + [0] * (self.context_length - len(ids))
        return ids
