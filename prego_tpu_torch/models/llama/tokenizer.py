"""Tokenizers for the LLaMA runtime.

Parity surface: llama/tokenizer.py:13-68 — a SentencePiece wrapper exposing
n_words/bos_id/eos_id/pad_id and encode(s, bos, eos)/decode(ids).

The sentencepiece package is not available in the target image, so this
module provides:

  * SentencePieceTokenizer — a from-scratch reader of SentencePiece
    ``tokenizer.model`` protobufs (minimal wire-format scanner, no protobuf
    dependency) plus the SentencePiece BPE merge algorithm with byte
    fallback — id-compatible with Meta's LLaMA-2 tokenizer files;
  * HFTokenizer — wraps a Hugging Face ``tokenizers`` tokenizer.json
    (available in the image) for HF-format checkpoints;
  * ByteTokenizer — hermetic byte-level tokenizer for tests.

All backends honour the same protocol; pad_id is -1 like SentencePiece's
default unset pad (llama/generation.py:168 relies on that sentinel).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Protocol, Tuple


class TokenizerProtocol(Protocol):
    n_words: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


# ---------------------------------------------------------------- byte-level

class ByteTokenizer:
    """UTF-8 bytes + {bos, eos} specials; deterministic and dependency-free."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = -1
        self.n_words = 258

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        t = list(s.encode("utf-8"))
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


# ------------------------------------------------------- sentencepiece model

_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

WHITESPACE_PIECE = "▁"  # ▁


@dataclass
class _Piece:
    text: str
    score: float
    type: int


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _scan_message(buf: bytes):
    """Yield (field_number, wire_type, value) triples of one protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_sentencepiece_model(path: str) -> List[_Piece]:
    """Extract the pieces list from a SentencePiece ModelProto file."""
    with open(path, "rb") as f:
        data = f.read()
    pieces: List[_Piece] = []
    for field, wire, val in _scan_message(data):
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            text, score, ptype = "", 0.0, _NORMAL
            for f2, w2, v2 in _scan_message(val):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(_Piece(text, score, ptype))
    if not pieces:
        raise ValueError(f"no pieces found in {path} — not a SentencePiece model?")
    return pieces


def serialize_sentencepiece_model(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Inverse of the parser — used to build test fixtures."""

    def varint(x: int) -> bytes:
        out = b""
        while True:
            b = x & 0x7F
            x >>= 7
            out += bytes([b | (0x80 if x else 0)])
            if not x:
                return out

    blob = b""
    for text, score, ptype in pieces:
        tb = text.encode("utf-8")
        inner = (
            bytes([0x0A]) + varint(len(tb)) + tb  # field 1: text
            + bytes([0x15]) + struct.pack("<f", score)  # field 2: score
            + bytes([0x18]) + varint(ptype)  # field 3: type
        )
        blob += bytes([0x0A]) + varint(len(inner)) + inner
    return blob


class SentencePieceTokenizer:
    """SentencePiece-BPE encoder/decoder compatible with LLaMA model files.

    Encoding follows sentencepiece's BPE algorithm: after normalization
    (dummy " " prefix, spaces mapped to ▁), repeatedly merge the adjacent
    symbol pair whose concatenation is the highest-scoring vocab piece
    (ties to the leftmost pair); symbols that end up outside the vocab use
    byte fallback (<0xXX> pieces) or the unk id.
    """

    def __init__(self, model_path: str, add_dummy_prefix: bool = True):
        self.pieces = parse_sentencepiece_model(model_path)
        self.piece_to_id: Dict[str, int] = {
            p.text: i for i, p in enumerate(self.pieces)
        }
        self.add_dummy_prefix = add_dummy_prefix
        self.n_words = len(self.pieces)
        self.unk_id = next(
            (i for i, p in enumerate(self.pieces) if p.type == _UNKNOWN), 0
        )
        self.bos_id = next(
            (i for i, p in enumerate(self.pieces) if p.text == "<s>"), 1
        )
        self.eos_id = next(
            (i for i, p in enumerate(self.pieces) if p.text == "</s>"), 2
        )
        self.pad_id = -1  # SentencePiece default: no pad piece
        self._byte_ids: Dict[int, int] = {}
        for i, p in enumerate(self.pieces):
            if p.type == _BYTE:
                self._byte_ids[int(p.text[1:-1], 16)] = i
        self._scores: Dict[str, float] = {
            p.text: p.score
            for p in self.pieces
            if p.type in (_NORMAL, _USER_DEFINED)
        }

    # -- encoding --

    def _normalize(self, s: str) -> str:
        # sentencepiece prepends the dummy prefix UNCONDITIONALLY (spm
        # normalizer.cc; HF LlamaConverter mirrors it as Prepend("▁")) —
        # " hello" normalizes to "▁▁hello", not "▁hello" — but an EMPTY
        # input stays empty (spm encodes "" to []).  Both caught by the
        # HF-tokenizers cross-validation in tests/test_tokenizer_cross.py.
        if self.add_dummy_prefix and s:
            s = " " + s
        return s.replace(" ", WHITESPACE_PIECE)

    def encode_as_pieces(self, s: str) -> List[str]:
        """SentencePiece BPE with the agenda algorithm: a max-heap of
        candidate merges with lazy invalidation over a doubly-linked symbol
        list — O(n log n) (a rescan-per-merge greedy is quadratic and takes
        minutes on few-shot-context-sized prompts)."""
        import heapq

        symbols = list(self._normalize(s))
        n = len(symbols)
        if n == 0:
            return []
        scores = self._scores
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        alive = [True] * n

        heap = []  # (-score, left_pos, merged_string)
        def push(i):
            j = nxt[i]
            if i < 0 or j < 0:
                return
            merged = symbols[i] + symbols[j]
            sc = scores.get(merged)
            if sc is not None:
                heapq.heappush(heap, (-sc, i, merged))

        for i in range(n - 1):
            push(i)

        while heap:
            negs, i, merged = heapq.heappop(heap)
            j = nxt[i] if i >= 0 else -1
            # lazy invalidation: the pair must still exist unchanged
            if i < 0 or j < 0 or not alive[i] or not alive[j]:
                continue
            if symbols[i] + symbols[j] != merged:
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            push(prv[i]) if prv[i] >= 0 else None
            push(i)

        out = []
        i = 0
        while i >= 0:
            if alive[i]:
                out.append(symbols[i])
            i = nxt[i]
        return out

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        ids: List[int] = []
        for piece in self.encode_as_pieces(s):
            pid = self.piece_to_id.get(piece)
            if pid is not None and self.pieces[pid].type != _UNUSED:
                ids.append(pid)
            else:  # byte fallback, else unk
                raw = piece.encode("utf-8")
                if self._byte_ids and all(b in self._byte_ids for b in raw):
                    ids.extend(self._byte_ids[b] for b in raw)
                else:
                    ids.append(self.unk_id)
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    # -- decoding --

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        byte_run: List[int] = []

        def flush_bytes():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            if not (0 <= i < self.n_words):
                continue
            p = self.pieces[i]
            if p.type == _BYTE:
                byte_run.append(int(p.text[1:-1], 16))
                continue
            flush_bytes()
            if p.type in (_CONTROL, _UNKNOWN):
                continue
            out.append(p.text.replace(WHITESPACE_PIECE, " "))
        flush_bytes()
        text = "".join(out)
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text


# ------------------------------------------------------------- hf tokenizers

class HFTokenizer:
    """Wraps a Hugging Face `tokenizers` tokenizer.json (HF llama exports)."""

    def __init__(
        self,
        tokenizer_json: str,
        bos_token: str = "<s>",
        eos_token: str = "</s>",
    ):
        from tokenizers import Tokenizer  # lazy import

        self.tk = Tokenizer.from_file(tokenizer_json)
        self.n_words = self.tk.get_vocab_size()
        self.bos_id = self.tk.token_to_id(bos_token)
        self.eos_id = self.tk.token_to_id(eos_token)
        self.pad_id = -1

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        ids = self.tk.encode(s, add_special_tokens=False).ids
        if bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: List[int]) -> str:
        return self.tk.decode(ids)


def load_tokenizer(path: str) -> TokenizerProtocol:
    """Pick a backend from the file type. The literal ``"byte"`` selects
    the hermetic ByteTokenizer (smoke-driving the serving CLI without a
    real tokenizer.model asset)."""
    if path == "byte":
        return ByteTokenizer()
    if path.endswith(".json"):
        return HFTokenizer(path)
    return SentencePieceTokenizer(path)
