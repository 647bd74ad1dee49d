"""BERT WordPiece tokenizer (copy of
`instance_based_loc_tpu/models/wordpiece.py`, which is pure Python).

BERT WordPiece tokenizer — host-side text preprocessing for the
GroundingDINO grounder (the reference tokenizes prompts through the BERT
tokenizer bundled with GroundingDINO). Matches Hugging Face `BertTokenizer`
(basic_tokenize + greedy longest-match-first wordpiece, lowercase, accent
stripping), so a `vocab.txt` from any BERT checkpoint drops in."""

from __future__ import annotations

import unicodedata


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab_path: str | None = None, vocab=None,
                 lowercase: bool = True, max_chars_per_word: int = 100):
        if vocab is None:
            vocab = {}
            if vocab_path is not None:
                with open(vocab_path, encoding="utf-8") as f:
                    for i, line in enumerate(f):
                        vocab[line.rstrip("\n")] = i
        self.vocab = dict(vocab)
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        self.unk = "[UNK]"
        self.cls_id = self.vocab.get("[CLS]", 101)
        self.sep_id = self.vocab.get("[SEP]", 102)

    # --- basic tokenization (HF BasicTokenizer semantics) ---
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
                continue
            out.append(" " if ch in ("\t", "\n", "\r") or
                       unicodedata.category(ch) == "Zs" else ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        tokens = []
        for tok in text.split():
            if self.lowercase:
                tok = self._strip_accents(tok.lower())
            cur = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # --- wordpiece (greedy longest-match-first) ---
    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = [self.vocab.get(t, self.vocab.get(self.unk, 100))
               for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids
