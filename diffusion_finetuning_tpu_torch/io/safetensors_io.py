"""Safetensors reading and writing with the reference LoRA schema (port of
the JAX package's ``io/safetensors_io.py``), on torch tensors.

The on-disk schema packs several models' LoRA weights and textual-inversion
embeddings into one file:

* tensor keys ``"{model}:{idx}:up"`` / ``"{model}:{idx}:down"``: the LoRA
  pair of the idx-th target of ``model`` in canonical order (``lora.py``);
* metadata ``"{model}"``: the JSON list of target ancestor class names;
* metadata ``"{model}:{idx}:rank"``: the rank as a decimal string;
* a TI embedding under its token string, with metadata ``token ->
  "<embed>"``.

Files are read straight into tensors (``torch.frombuffer`` over the file's
bytes, bf16 included: no numpy bf16 type is needed) and written from each
tensor's bytes.  The writer is the JAX package's canonical one (:89-116):
tensor keys sorted, data offsets in key order, metadata keys sorted, compact
JSON, no header padding; so a file written here is byte-identical to the
JAX writer's for the same tensors and metadata.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

EMBED_FLAG = "<embed>"

__all__ = [
    "EMBED_FLAG",
    "read_safetensors",
    "write_safetensors",
    "write_safeloras",
    "parse_safeloras",
    "parse_safeloras_embeds",
    "load_safeloras",
    "load_safeloras_embeds",
    "load_safeloras_both",
]

_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str, device=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """(tensors, metadata) of a .safetensors file.  The tensors share one
    writable host buffer holding the file's data; with ``device`` each is
    moved there."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        body = bytearray(f.read())
    metadata = header.pop("__metadata__", {}) or {}
    tensors = {}
    for name, info in header.items():
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        t = (torch.frombuffer(body, dtype=dtype, count=count, offset=start) if count
             else torch.empty(0, dtype=dtype))
        t = t.reshape(info["shape"])
        tensors[name] = t if device is None else t.to(device)
    return tensors, metadata


def _raw(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def write_safetensors(tensors: Mapping[str, Any], path: str,
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (tensors, or anything ``torch.as_tensor`` takes)
    with the canonical layout of the JAX writer."""
    metadata = dict(metadata or {})
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: metadata[k] for k in sorted(metadata)}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name])
        if t.ndim == 0:  # the JAX writer's np.ascontiguousarray makes a 0-d array 1-d
            t = t.reshape(1)
        raw = _raw(t)
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in blobs:
            f.write(raw)


def write_safeloras(loras: Mapping[str, Tuple[Sequence[torch.Tensor], Sequence[int],
                                               Sequence[str]]],
                    path: str, embeds: Optional[Mapping[str, torch.Tensor]] = None,
                    dtype: Optional[torch.dtype] = None) -> None:
    """Write the reference multi-model schema.  ``loras``: {model: (flat
    [up0, down0, up1, down1, ...], per-pair ranks, target ancestor class
    names)}; ``embeds``: {token: (dim,)}."""
    tensors: Dict[str, torch.Tensor] = {}
    metadata: Dict[str, str] = {}
    for name, (weights, ranks, target) in loras.items():
        if len(weights) != 2 * len(ranks):
            raise ValueError(f"model {name}: {len(weights)} tensors but {len(ranks)} ranks")
        metadata[name] = json.dumps(list(target))
        for i, rank in enumerate(ranks):
            metadata[f"{name}:{i}:rank"] = str(int(rank))
            tensors[f"{name}:{i}:up"] = torch.as_tensor(weights[2 * i])
            tensors[f"{name}:{i}:down"] = torch.as_tensor(weights[2 * i + 1])
    for token, embed in (embeds or {}).items():
        metadata[token] = EMBED_FLAG
        tensors[token] = torch.as_tensor(embed)
    if dtype is not None:
        tensors = {k: v.to(dtype) for k, v in tensors.items()}
    write_safetensors(tensors, path, metadata)


def parse_safeloras(tensors: Mapping[str, torch.Tensor], metadata: Mapping[str, str]
                    ) -> Dict[str, Tuple[List[torch.Tensor], List[int], List[str]]]:
    """{model: (flat weights, ranks, targets)}: tensor keys grouped by the
    prefix before the first ':', TI embeds skipped, ranks and targets from
    the metadata, pairs by index with up before down."""
    loras: Dict[str, Tuple[List[torch.Tensor], List[int], List[str]]] = {}
    by_model: Dict[str, List[str]] = {}
    for key in tensors:
        if ":" not in key:
            continue  # an embed or a foreign key
        model = key.split(":", 1)[0]
        if metadata.get(model) == EMBED_FLAG:
            continue
        by_model.setdefault(model, []).append(key)

    for model, keys in by_model.items():
        target_json = metadata.get(model)
        if target_json is None:
            raise ValueError(f"Tensor {keys[0]} has model {model} but no target metadata")
        target = json.loads(target_json)
        idxs = sorted({int(k.split(":")[1]) for k in keys})
        if idxs != list(range(len(idxs))):
            raise ValueError(f"model {model}: non-contiguous LoRA indices {idxs}")
        weights: List[torch.Tensor] = []
        ranks: List[int] = []
        for i in idxs:
            try:
                ranks.append(int(metadata[f"{model}:{i}:rank"]))
            except KeyError:
                raise ValueError(f"model {model}: missing '{model}:{i}:rank' metadata "
                                 "(malformed safelora file)") from None
            for part in ("up", "down"):
                key = f"{model}:{i}:{part}"
                if key not in tensors:
                    raise ValueError(f"model {model}: tensor '{key}' missing — up/down "
                                     "pairs must both be present")
                weights.append(tensors[key])
        loras[model] = (weights, ranks, target)
    return loras


def parse_safeloras_embeds(tensors: Mapping[str, torch.Tensor], metadata: Mapping[str, str]
                           ) -> Dict[str, torch.Tensor]:
    """{token: embedding} for every tensor flagged as an embed."""
    return {k: v for k, v in tensors.items() if metadata.get(k) == EMBED_FLAG}


def load_safeloras(path: str):
    return parse_safeloras(*read_safetensors(path))


def load_safeloras_embeds(path: str):
    return parse_safeloras_embeds(*read_safetensors(path))


def load_safeloras_both(path: str):
    tensors, metadata = read_safetensors(path)
    return parse_safeloras(tensors, metadata), parse_safeloras_embeds(tensors, metadata)
