"""Host-staged KV-block transfer between replicas' paged pools.

Port of the JAX package's ``serving/kv_transfer.py``: the wire format of
disaggregated serving (:mod:`.disagg`).  A transferred unit is one
physical block, ``block_size`` token rows of every layer's key and value
pool, addressed by the pool's content-chained prefix key
(:meth:`.kv_pool.PagedKVPool.cached_chain`) and sealed with a CRC-32 over
its identity and raw bytes.  Equal keys imply bitwise-equal K/V (the same
prefill on the same weights), so an imported block is interchangeable
with one the importer would have computed.

The leaves are named as the JAX pool's tree paths
(``block{i}/attn/k_pool``, ``block{i}/attn/v_pool``) and sorted by name
on both ends, so :func:`payload_checksum` over f32 rows equals the JAX
package's on the same arrays.  bf16 has no numpy dtype: a bf16 leaf is
staged as a ``uint16`` view, and the payload's ``dtypes`` names it
``bfloat16`` in the checksum's header, as JAX's ``ml_dtypes`` array does.

The pool is written in place, so a :class:`BlockRef` cannot be a view of
it (the JAX package relies on immutable arrays, ``:113-121``): the
scheduler thread gathers the chain's rows into a private copy
(``index_select``) at a tick boundary and records a CUDA event after it;
:func:`materialize_payloads` waits on that event before the copy to the
host, on whatever thread runs it.  :func:`scatter_payloads` writes the
accepted rows back with plain torch indexing (JAX: ``.at[rows].set``),
and never casts: the importer rejects a payload whose leaves, dtypes or
shapes differ from its pool's (:func:`payload_mismatch`), as it rejects a
bad CRC, so equal keys keep meaning bitwise-equal K/V.
No locks, no threads: the scheduler decides when these run.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BlockPayload",
    "BlockRef",
    "corrupt_payload",
    "extract_block_refs",
    "extract_payloads",
    "materialize_payloads",
    "payload_checksum",
    "payload_mismatch",
    "pool_row_leaves",
    "scatter_payloads",
    "verify_payload",
]


def pool_row_leaves(pool, n_rows: int) -> List[Tuple[str, torch.Tensor]]:
    """``(name, rows)`` for every layer's key and value pool, sorted by
    name; ``rows`` is the first ``n_rows`` rows (the sink row left out)."""
    out = []
    for i, (k, v) in enumerate(zip(pool.keys, pool.values)):
        out.append((f"block{i}/attn/k_pool", k[:n_rows]))
        out.append((f"block{i}/attn/v_pool", v[:n_rows]))
    out.sort(key=lambda kv: kv[0])
    return out


def _dtype_name(arr: np.ndarray, dtypes: Optional[Dict[str, str]], name: str) -> str:
    return (dtypes or {}).get(name, str(arr.dtype))


def payload_checksum(key: tuple, index: int, arrays: Dict[str, np.ndarray],
                     dtypes: Optional[Dict[str, str]] = None) -> int:
    """CRC-32 chained over the block's identity, then each leaf's
    ``name:dtype:shape`` header and raw bytes, leaves sorted by name (JAX
    ``:77-92``).  ``dtypes`` overrides a leaf's dtype name (``bfloat16``
    for a ``uint16`` view)."""
    crc = zlib.crc32(repr((key, index)).encode())
    for name in sorted(arrays):
        arr = arrays[name]
        crc = zlib.crc32(f"{name}:{_dtype_name(arr, dtypes, name)}:{arr.shape}".encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc & 0xFFFFFFFF


@dataclass
class BlockPayload:
    """One block in flight: ``block_size`` rows of every pool leaf on the
    host, keyed by its chain key, CRC-sealed."""

    key: tuple
    index: int  # position of this block in the prefix chain, 0-based
    arrays: Dict[str, np.ndarray]  # leaf name -> [block_size, heads, head_dim]
    crc: int
    dtypes: Dict[str, str] = field(default_factory=dict)  # leaf name -> torch dtype name

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays.values())


@dataclass
class BlockRef:
    """One block selected for transfer, not yet on the host: rows of a
    private device copy of the chain (the pool itself moves on), and the
    event recorded after that copy."""

    key: tuple
    index: int
    slices: Dict[str, torch.Tensor]  # leaf name -> [block_size, heads, head_dim]
    ready: Any = None  # torch.cuda.Event on the card, None on the CPU


def _rows(blocks: Sequence[int], bs: int) -> np.ndarray:
    return np.concatenate([np.arange(b * bs, (b + 1) * bs) for b in blocks])


def extract_block_refs(kv, pool, prompt: Sequence[int], namespace=None) -> List[BlockRef]:
    """The longest cached chain of ``prompt`` as refs.  On the scheduler
    thread: one gather a leaf, no wait on the device."""
    chain = kv.cached_chain(prompt, namespace)
    if not chain:
        return []
    bs = kv.block_size
    leaves = pool_row_leaves(pool, kv.num_blocks * bs)
    device = leaves[0][1].device
    rows = torch.from_numpy(_rows([blk for _, blk in chain], bs)).to(device)
    gathered = {name: leaf.index_select(0, rows) for name, leaf in leaves}
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return [
        BlockRef(key=key, index=i, ready=ready,
                 slices={name: g[i * bs:(i + 1) * bs] for name, g in gathered.items()})
        for i, (key, _) in enumerate(chain)
    ]


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A device tensor's rows on the host and its dtype's name; bf16 as
    its ``uint16`` bits."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def materialize_payloads(refs: Sequence[BlockRef],
                         chunk_rows: Optional[int] = None) -> List[BlockPayload]:
    """Copy refs to the host and seal them (any thread).  ``chunk_rows``
    bounds each copy to that many rows (``None``: a leaf's block in one)."""
    if chunk_rows is not None and chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    out: List[BlockPayload] = []
    for ref in refs:
        if ref.ready is not None:
            ref.ready.synchronize()
        arrays: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for name, sl in ref.slices.items():
            n = sl.shape[0]
            if chunk_rows is None or chunk_rows >= n:
                arrays[name], dtypes[name] = _to_host(sl)
            else:
                parts = [_to_host(sl[i:i + chunk_rows]) for i in range(0, n, chunk_rows)]
                arrays[name] = np.concatenate([p for p, _ in parts])
                dtypes[name] = parts[0][1]
        out.append(BlockPayload(key=ref.key, index=ref.index, arrays=arrays, dtypes=dtypes,
                                crc=payload_checksum(ref.key, ref.index, arrays, dtypes)))
    return out


def extract_payloads(kv, pool, prompt: Sequence[int], namespace=None) -> List[BlockPayload]:
    """:func:`extract_block_refs` and :func:`materialize_payloads` in one
    call, on the calling thread."""
    return materialize_payloads(extract_block_refs(kv, pool, prompt, namespace=namespace))


def verify_payload(payload: BlockPayload) -> bool:
    """Recompute the CRC over what arrived."""
    return payload_checksum(payload.key, payload.index, payload.arrays,
                            payload.dtypes) == payload.crc


def payload_mismatch(payload: BlockPayload, pool, block_size: int) -> Optional[str]:
    """Why ``payload`` cannot land in ``pool`` bit for bit (``None``: it
    can): its leaves, a leaf's dtype or its shape differ from the pool's.
    A cast would publish other bytes under the same content key."""
    leaves = dict(pool_row_leaves(pool, block_size))
    if set(payload.arrays) != set(leaves):
        return "leaf names differ from the pool's"
    for name, leaf in leaves.items():
        arr = payload.arrays[name]
        want = str(leaf.dtype).replace("torch.", "")
        got = _dtype_name(arr, payload.dtypes, name)
        if got != want or arr.dtype.itemsize != leaf.element_size():
            return f"{name} is {got}, the pool's is {want}"
        if tuple(arr.shape) != tuple(leaf.shape):
            return f"{name} has shape {tuple(arr.shape)}, the pool's block {tuple(leaf.shape)}"
    return None


def corrupt_payload(payload: BlockPayload) -> None:
    """Flip the first byte of the first leaf after sealing (the
    ``kv_transfer_corrupt`` fault): the stale CRC must reject it."""
    name = sorted(payload.arrays)[0]
    arr = payload.arrays[name]
    raw = bytearray(arr.tobytes())
    raw[0] ^= 0xFF
    payload.arrays[name] = np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)


def _to_device(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


@torch.inference_mode()
def scatter_payloads(pool, n_rows: int, accepted: List[Tuple[int, BlockPayload]]):
    """Write accepted payloads into the blocks the importer adopted for
    them (``(local block id, payload)``; block ids are the importer's
    own), one indexed write a leaf, in place.  Returns ``pool``."""
    if not accepted:
        return pool
    leaves = dict(pool_row_leaves(pool, n_rows))
    first = accepted[0][1]
    names = sorted(first.arrays)
    bs = first.arrays[names[0]].shape[0]
    device = next(iter(leaves.values())).device
    rows = torch.from_numpy(_rows([blk for blk, _ in accepted], bs)).to(device)
    for name in names:
        if name not in leaves:
            raise KeyError(f"payload leaf {name!r} is not a leaf of this pool")
        vals = np.concatenate([p.arrays[name] for _, p in accepted])
        leaf = leaves[name]
        t = _to_device(vals, first.dtypes.get(name, str(vals.dtype)), device)
        if t.dtype != leaf.dtype or t.shape[1:] != leaf.shape[1:]:
            # no cast: equal keys must mean bitwise-equal K/V
            raise ValueError(f"payload leaf {name!r} is {t.dtype} {tuple(t.shape[1:])}, "
                             f"the pool's {leaf.dtype} {tuple(leaf.shape[1:])}")
        leaf[rows] = t
    return pool
