"""Self-contained CLIP BPE tokenizer.

The port's own copy of ``genima_tpu/data/tokenizer.py`` (``ClipTokenizer``,
``HashTokenizer``, ``load_tokenizer``), so the port imports nothing of the
JAX package. The reference tokenizes prompts with HF ``CLIPTokenizer`` for
the diffusion stage and OpenAI ``clip``'s tokenizer for the controller's
language conditioning. Both are byte-level BPE over the same 49152-token
merge table, lower-cased, with <|startoftext|> / <|endoftext|> specials and
77-token context.

Vocabulary sources, in order:

* ``merges_path`` -- OpenAI's ``bpe_simple_vocab_16e6.txt[.gz]`` (the vocab is
  derived from the merge list alone, so one file suffices), or an HF
  ``merges.txt``;
* a synthetic merge list (tests);
* if no vocabulary is available, :class:`HashTokenizer` provides a
  deterministic stand-in with the same interface so end-to-end pipelines and
  trainers remain runnable (embeddings are then only meaningful with
  checkpoints trained against it -- weight-ported CLIP checkpoints require
  the real merge table).
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte<->unicode table (identical in CLIP)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# OpenAI CLIP pattern: ...|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+ — words are
# LETTERS ONLY, digits tokenize ONE AT A TIME, and underscore belongs to the
# punctuation class. (stdlib re: [^\W\d_] = \p{L}; (?:[^\s\w]|_) = not
# space/letter/digit.) The JAX package's tests hold it to
# transformers.CLIPTokenizer on a shared merge table.
_TOKEN_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


class ClipTokenizer:
    """CLIP byte-level BPE (OpenAI ``SimpleTokenizer`` semantics)."""

    def __init__(self, merges: list[tuple[str, str]], context_length: int = CONTEXT_LENGTH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @classmethod
    def from_merges_file(cls, path: str | Path, **kw) -> "ClipTokenizer":
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # OpenAI file: first line is a header-ish token list; HF merges.txt
        # starts with a "#version" comment.
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
            merge_lines = [ln for ln in lines if ln.strip()]
        else:
            merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(ln.split()) for ln in merge_lines if len(ln.split()) == 2]
        return cls(merges, **kw)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _TOKEN_PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: list[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(
        self, texts: str | list[str], context_length: int | None = None
    ) -> np.ndarray:
        """Tokenize to a padded (N, 77) int32 array, truncating like the
        reference (``truncate=True`` / HF ``truncation=True``): the last slot
        always holds EOT."""
        if isinstance(texts, str):
            texts = [texts]
        n_ctx = context_length or self.context_length
        result = np.zeros((len(texts), n_ctx), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > n_ctx:
                tokens = tokens[: n_ctx - 1] + [self.eot]
            result[i, : len(tokens)] = tokens
        return result


class HashTokenizer:
    """Deterministic fallback tokenizer with the ClipTokenizer interface.

    Maps each whitespace word to a stable hash bucket in the CLIP vocab
    range. Lets every pipeline/trainer/test run without the BPE merge table;
    NOT compatible with weight-ported CLIP checkpoints.
    """

    def __init__(self, context_length: int = CONTEXT_LENGTH, vocab_size: int = VOCAB_SIZE):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> list[int]:
        import hashlib

        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        out = []
        for w in words:
            if not w:
                continue
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(h % (self.vocab_size - 2))
        return out

    def __call__(
        self, texts: str | list[str], context_length: int | None = None
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        n_ctx = context_length or self.context_length
        result = np.zeros((len(texts), n_ctx), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > n_ctx:
                tokens = tokens[: n_ctx - 1] + [self.eot]
            result[i, : len(tokens)] = tokens
        return result


# default location for a vendored OpenAI merge table (none is committed)
VENDORED_VOCAB = Path(__file__).parent / "bpe_simple_vocab_16e6.txt.gz"


def discover_merges(model_dir: str | Path) -> Path | None:
    """Find a CLIP ``merges.txt`` inside a local HF model snapshot.

    SD/SDXL snapshots (e.g. ``stabilityai/sd-turbo``) ship the tokenizer
    files in ``tokenizer/`` (and ``tokenizer_2/`` for SDXL): a real-weights
    run already has them on disk, so the merge table needs no separate
    download.
    """
    model_dir = Path(model_dir)
    if model_dir.is_file():
        return model_dir if model_dir.name.endswith(("merges.txt",)) else None
    if not model_dir.is_dir():
        return None
    for sub in ("tokenizer", "tokenizer_2", "."):
        cand = model_dir / sub / "merges.txt"
        if cand.exists():
            return cand
    return None


def load_tokenizer(
    merges_path: str | Path | None = None,
    allow_hash_fallback: bool = True,
    model_dir: str | Path | None = None,
):
    """Real CLIP BPE when a merge table is given, discoverable, or vendored.

    Resolution order: explicit ``merges_path`` (a merges file, or a
    directory to :func:`discover_merges` in) -> ``model_dir`` discovery
    (the ``--pretrained_model_name_or_path`` snapshot) -> a vendored
    ``genima_torch/data/bpe_simple_vocab_16e6.txt.gz`` -> :class:`HashTokenizer`
    with a LOUD warning (never silently: ported CLIP weights are incompatible
    with the hash stand-in). Pass ``allow_hash_fallback=False`` to make the
    missing table a hard error instead.
    """
    if merges_path is not None:
        p = Path(merges_path)
        if p.is_dir():
            found = discover_merges(p)
            if found is None:
                raise FileNotFoundError(
                    f"tokenizer_merges={merges_path} is a directory with no "
                    "tokenizer/merges.txt inside"
                )
            return ClipTokenizer.from_merges_file(found)
        if not p.exists():
            raise FileNotFoundError(
                f"tokenizer_merges={merges_path} does not exist"
            )
        return ClipTokenizer.from_merges_file(p)
    if model_dir is not None:
        found = discover_merges(model_dir)
        if found is not None:
            return ClipTokenizer.from_merges_file(found)
    if VENDORED_VOCAB.exists():
        return ClipTokenizer.from_merges_file(VENDORED_VOCAB)
    if not allow_hash_fallback:
        raise FileNotFoundError(
            "No CLIP merge table: pass tokenizer_merges=... or vendor "
            f"{VENDORED_VOCAB}. Refusing the hash stand-in "
            "(allow_hash_fallback=False)."
        )
    import warnings

    warnings.warn(
        "CLIP merge table not found - falling back to the deterministic "
        "HASH tokenizer. Checkpoints trained with real CLIP weights will "
        "receive MEANINGLESS language tokens. Pass tokenizer_merges=... "
        f"or vendor {VENDORED_VOCAB}.",
        stacklevel=2,
    )
    return HashTokenizer()
