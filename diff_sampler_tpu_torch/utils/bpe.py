"""From-scratch CLIP byte-pair-encoding tokenizer.

Counterpart of ``diff_sampler_tpu/utils/bpe.py``, copied so that the port
imports nothing of the JAX package; it gives the same ids bit for bit
(tests/test_torch_text.py).  The reference feeds SD caption conditioning
through the HF CLIPTokenizer (``ldm/modules/encoders/modules.py:142``) and
computes CLIP scores with open_clip's SimpleTokenizer; both are the same BPE
scheme over the same 49,152-merge vocab, and only the merges / vocab FILE is
an artifact.  This module implements the algorithm (byte -> unicode remap,
greedy lowest-rank pair merging, the CLIP word-split regex, SOT / EOT
framing at context length 77), so the SD caption path needs one local vocab
file and no network.

Accepted vocab artifacts (auto-detected):
  * open_clip's ``bpe_simple_vocab_16e6.txt.gz`` (first line is a version
    banner; merges follow, space-separated),
  * a HuggingFace ``merges.txt`` (first line ``#version: ...``).

``find_vocab_file`` looks at an explicit path, ``$CLIP_BPE_VOCAB``, then
``assets/`` at the repository root, ``~/.cache/clip`` and
``~/.cache/open_clip``.  Nothing is downloaded.

Padding semantics: open_clip pads with 0, transformers' CLIPTokenizer pads
with EOT (its pad token).  Both pool at the FIRST EOT (argmax of ids), so
the pooled embedding is identical; ``pad_id`` selects the convention.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SimpleBPETokenizer", "bytes_to_unicode", "find_vocab_file", "vocab_candidates"]

_SOT = "<|startoftext|>"
_EOT = "<|endoftext|>"

# CLIP's word-split pattern: special tokens, common English contractions,
# letter runs, single digits, punctuation runs.  Requires the `regex`
# module for \p{} classes (a hard dependency of transformers, so present
# wherever this framework runs).
_PAT = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-char map (GPT-2/CLIP scheme).

    Printable ASCII and two Latin-1 ranges map to themselves; the remaining
    68 bytes map to 256+i so every byte becomes a single visible character
    and BPE can operate on unicode strings without unknowns."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    mapping = {}
    shift = 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _read_merges(path: str, limit: int = 48894) -> List[Tuple[str, str]]:
    """Read merge rules from either accepted artifact format.

    limit is open_clip's slice (49152 - 256 - 2 merges + 1 header line):
    the published gz file carries more lines than the vocab uses."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        lines = lines[1:limit + 1]
    else:
        with open(path, encoding="utf-8") as f:
            lines = [ln for ln in f.read().split("\n") if ln]
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        lines = lines[:limit]
    merges = []
    for ln in lines:
        parts = ln.split()
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    return merges


def vocab_candidates(explicit: Optional[str] = None) -> List[str]:
    """The paths ``find_vocab_file`` tries, in order: ``explicit``,
    $CLIP_BPE_VOCAB, then the usual cache spots."""
    candidates = [explicit, os.environ.get("CLIP_BPE_VOCAB")]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    home = os.path.expanduser("~")
    for base in (os.path.join(repo, "assets"),
                 os.path.join(home, ".cache", "clip"),
                 os.path.join(home, ".cache", "open_clip")):
        candidates.append(os.path.join(base, "bpe_simple_vocab_16e6.txt.gz"))
        candidates.append(os.path.join(base, "merges.txt"))
    return [c for c in candidates if c]


def find_vocab_file(explicit: Optional[str] = None) -> Optional[str]:
    """Locate a local BPE vocab artifact among ``vocab_candidates``.
    Returns None when nothing exists."""
    return next((c for c in vocab_candidates(explicit) if os.path.isfile(c)), None)


class SimpleBPETokenizer:
    """CLIP BPE tokenizer over a local merges file.

    __call__(texts) -> [B, context_length] int32 ids framed SOT ... EOT,
    truncated so the last position is always EOT, padded with ``pad_id``
    (0 = open_clip convention; pass the EOT id for transformers parity).
    """

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 context_length: int = 77, pad_id: int = 0):
        byte_map = bytes_to_unicode()
        chars = list(byte_map.values())
        vocab = chars + [c + "</w>" for c in chars]
        vocab += ["".join(m) for m in merges]
        vocab += [_SOT, _EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_map = byte_map
        self.byte_unmap = {v: k for k, v in byte_map.items()}
        self.context_length = context_length
        self.pad_id = pad_id
        self.sot_id = self.encoder[_SOT]
        self.eot_id = self.encoder[_EOT]
        self._cache = {_SOT: _SOT, _EOT: _EOT}
        import regex
        self._pat = regex.compile(_PAT, regex.IGNORECASE)

    @classmethod
    def from_file(cls, path: str, **kw) -> "SimpleBPETokenizer":
        return cls(_read_merges(path), **kw)

    @classmethod
    def from_default_paths(cls, explicit: Optional[str] = None,
                           **kw) -> "SimpleBPETokenizer":
        path = find_vocab_file(explicit)
        if path is None:
            raise FileNotFoundError(
                f"no CLIP BPE vocab file (bpe_simple_vocab_16e6.txt.gz or merges.txt) at "
                f"any of {vocab_candidates(explicit)}: set $CLIP_BPE_VOCAB or place one "
                f"there; nothing is downloaded")
        return cls.from_file(path, **kw)

    # -- core BPE ----------------------------------------------------------
    def _bpe(self, token: str) -> str:
        """Greedy merge: repeatedly join the present pair with the lowest
        merge rank until no ranked pair remains.  The word's final char
        carries the </w> end-of-word marker."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = word[0]
            return word[0]
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """text -> BPE ids (no SOT/EOT framing)."""
        text = html.unescape(html.unescape(text))
        text = " ".join(text.split()).strip().lower()
        ids: List[int] = []
        for token in self._pat.findall(text):
            mapped = "".join(self.byte_map[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i not in (self.sot_id, self.eot_id, self.pad_id))
        raw = bytes(self.byte_unmap[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        n = self.context_length
        out = np.full((len(texts), n), self.pad_id, np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text)[:n - 2] + [self.eot_id]
            out[row, :len(ids)] = ids
        return out
