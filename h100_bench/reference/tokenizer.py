"""CLIP's byte-pair tokenizer, for prompts of lowercase ASCII words.

The benchmark makes one vocabulary and merge list (:func:`vocabulary`: the
256 byte symbols, each again with the end-of-word mark, then every word of
its word list by a chain of merges, then the start and end tokens) and
hands it to the program's tokenizer and to :func:`encode` alike.  The SD
checkpoints' 49,408-row vocabulary file is not in the repository; the text
tower keeps its 49,408 embedding rows and 77 positions.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

MAX_LENGTH = 77


def _byte_symbols() -> List[str]:
    """GPT-2's byte -> unicode table, as CLIP's, in byte order of its list."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs]


def vocabulary(words: Sequence[str]) -> Tuple[Dict[str, int], List[str]]:
    """(vocab, merges) holding every byte and every word of ``words``."""
    syms = _byte_symbols()
    vocab: Dict[str, int] = {}
    for s in syms:
        vocab[s] = len(vocab)
    for s in syms:
        vocab[s + "</w>"] = len(vocab)
    merges: List[str] = []
    for w in words:
        if w + "</w>" in vocab:
            continue
        acc = w[0]
        for ch in w[1:-1]:
            merges.append(f"{acc} {ch}")
            acc += ch
            vocab.setdefault(acc, len(vocab))
        merges.append(f"{acc} {w[-1]}</w>")
        vocab[w + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def _bpe(word: str, ranks: Dict[Tuple[str, str], int]) -> List[str]:
    parts = list(word[:-1]) + [word[-1] + "</w>"]
    while len(parts) > 1:
        pairs = [(ranks.get((a, b), float("inf")), i)
                 for i, (a, b) in enumerate(zip(parts, parts[1:]))]
        rank, _ = min(pairs)
        if rank == float("inf"):
            break
        first, second = next(p for p in zip(parts, parts[1:])
                             if ranks.get(p) == rank)
        merged, i = [], 0
        while i < len(parts):
            if i < len(parts) - 1 and (parts[i], parts[i + 1]) == (first, second):
                merged.append(first + second)
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        parts = merged
    return parts


def encode(prompts: Sequence[str], vocab: Dict[str, int], merges: Sequence[str]) -> List[List[int]]:
    """Token ids of each prompt: start, the words' BPE symbols, end, then
    the end token as padding to 77."""
    ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    out = []
    for p in prompts:
        ids = [bos]
        for w in p.lower().split():
            ids += [vocab.get(s, eos) for s in _bpe(w, ranks)]
        ids = ids[:MAX_LENGTH - 1] + [eos]
        out.append(ids + [eos] * (MAX_LENGTH - len(ids)))
    return out
